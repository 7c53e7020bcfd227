"""The CUDA BCS kernel against its plain PyTorch version, on the card.

Every test here is marked ``cuda`` and skips without a card (the kernel
has no CPU mode).  This file imports neither jax nor the JAX package, so
it runs on the card's machine:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.kernels import bsr_matmul as K  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.trainer import apply_masks  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _layout(dev, K_, N_, block, dtype, reorder, seed=0):
    rng = np.random.RandomState(seed)
    bk, bn = block
    live = rng.rand(K_ // bk, N_ // bn) < 0.4
    live[:, -1] = True
    mask = torch.from_numpy(np.repeat(np.repeat(live, bk, 0), bn, 1)).to(dev)
    w = torch.from_numpy(rng.randn(K_, N_).astype(np.float32)).to(dev, dtype)
    return ops.pack(w, mask, block, reorder=reorder), w * mask.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [(16, 16), (8, 16), (4, 4), (16, 32)])
@pytest.mark.parametrize("M", [1, 4, 129])
def test_kernel_matches_plain(cuda, M, block, dtype):
    lay, _ = _layout(cuda, 256, 384, block, dtype, reorder=True)
    unre, _ = _layout(cuda, 256, 384, block, dtype, reorder=False)
    x = torch.randn(M, 256, device=cuda).to(dtype)
    b = torch.randn(384, device=cuda).to(dtype)
    for act in ("none", "silu", "relu"):
        before = K.LAUNCHES["bsr_matmul"]
        y = K.bsr_matmul_packed(x, lay, bias=b, act=act)
        torch.cuda.synchronize()
        assert K.LAUNCHES["bsr_matmul"] - before == lay.n_bins
        assert torch.equal(y, K.bsr_matmul_packed(x, unre, bias=b, act=act))
        want = ref.bsr_matmul_packed_ref(x.float(), lay, b.float(), act)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(y.float(), want, rtol=tol, atol=tol)


def test_single_bin_and_no_bias(cuda):
    lay, dense = _layout(cuda, 128, 64, (16, 16), torch.float32, False)
    x = torch.randn(5, 128, device=cuda)
    assert lay.n_bins == 1
    y = K.bsr_matmul_packed(x, lay)
    torch.testing.assert_close(y, x @ dense, rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    lay, _ = _layout(cuda, 128, 64, (16, 16), torch.float32, False)
    x = torch.randn(5, 128, device=cuda)
    with pytest.raises(TypeError):
        K.bsr_matmul_packed(x.to(torch.bfloat16), lay)       # dtype mix
    with pytest.raises(ValueError):
        K.bsr_matmul_packed(x[:, :64], lay)                   # K mismatch
    with pytest.raises(ValueError):
        K.bsr_matmul_packed(x.t().contiguous().t(), lay)      # strides
    with pytest.raises(ValueError):
        K.bsr_matmul_packed(x, lay, act="gelu")


def test_generate_on_card_matches_cpu(cuda):
    """fp32 yi-9b SMOKE, pruned and compiled: the card's greedy tokens
    equal the CPU plain path's, through the kernel at every projection."""
    cfg = configs.get("yi-9b", smoke=True)
    spec = [(r"(attn/w[qkvo]|ffn/(gate|up|down))/w",
             RW.SchemeChoice("block", (16, 16)))]
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, size=(2, 8))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = T.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
        masks = RW.magnitude_block_masks(p, spec, None, rate=0.6)
        exec_p, _ = C.compile_model(apply_masks(p, masks), masks, spec,
                                    spec=C.CompileSpec(keep_dense=False),
                                    device=dev)
        bins = sum(node["packed"].n_bins for g in ("attn", "ffn")
                   for node in exec_p["layers"][g].values())
        K.reset_launches()
        outs[dev] = engine.generate(exec_p, cfg, tokens, 10,
                                    device=dev).cpu()
        launches = K.LAUNCHES["bsr_matmul"]
        assert launches == (cfg.n_layers * bins * 11 if dev == "cuda" else 0)
    assert torch.equal(outs["cuda"], outs["cpu"])
