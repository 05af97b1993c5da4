"""Deprecated shim — the LM serving functions live in
:mod:`repro_torch.models.lm_serve` (they drive the transformer model and
belong next to it; ``repro_torch.serve`` is the factor-snapshot serving
subsystem).

The port's copy of the reference package's ``serving/serve.py``: importing
this module re-exports the old surface and emits a
:class:`DeprecationWarning`; import ``repro_torch.models.lm_serve`` instead.
"""
from __future__ import annotations

import warnings

from repro_torch.models.lm_serve import (cache_specs, generate,  # noqa: F401
                                         make_decode_step, make_prefill_step)

__all__ = ["make_prefill_step", "make_decode_step", "cache_specs", "generate"]

warnings.warn(
    "repro_torch.serving.serve is deprecated; import "
    "repro_torch.models.lm_serve instead", DeprecationWarning, stacklevel=2)
