"""One train step of half the ``ARCH_IDS`` smoke configs in the port
against the reference's jitted ``make_train_step``, on the reference's
weights, under remat ``none``, ``full`` and ``dots``
(tests/_torch_train_cases.py; tests/test_torch_training.py holds the other
half). Mamba (jamba), MLA + MoE (deepseek), the encoder-decoder (whisper,
with ``frames``), cross-attention (llama-vision, with ``images``) and
RWKV6 are here.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_train_cases as cases  # noqa: E402

ARCHS = ["jamba15_large", "deepseek_v2_lite", "whisper_small",
         "llama32_vision_90b", "rwkv6_7b"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one thread: the suite runs files in parallel
    workers, and timing-sensitive reference tests share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, remat):
    cases.check_train_step(arch, remat)
