"""repro_torch.models — the LM substrate of the port: transformer families,
the attention / MoE / MLA / SSM mixers and the serving functions.

The counterpart of the reference package's ``repro.models`` in plain
PyTorch, with the reference's module and function names: ``common`` (norms,
rotary embeddings, init), ``attention``, ``ffn``, ``ssm``, ``transformer``
(:class:`~repro_torch.models.transformer.Model`, an ``nn.Module``),
``lm_serve`` (prefill / decode wrappers and :func:`generate`), ``convert``
(the reference's parameter pytree carried in and out) and the one-controller
stand-ins ``shardctx`` and ``sharding``. No Pallas kernel of the reference
lies on this path, so none is ported here.
"""
