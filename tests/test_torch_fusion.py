"""The paper's compiler extras ported verbatim, against the reference:
``core.fusion`` (``plan_fusions``, ``fusion_legal``, ``fuse_weights``)
over every ported config, and ``core.autotune`` (``tile_candidates``,
``tune_tiles``, priced for a TPU v5e as the reference prices them) over a
grid of (M, K, N)."""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import autotune as ref_AT  # noqa: E402
from repro.core import fusion as ref_F  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import autotune as AT  # noqa: E402
from repro_torch.core import fusion as F  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402

ARCHS = sorted(configs.ALIASES)
TOKENS = (1, 128, 4096)
# (path regex, scheme, block) rule lists: the serving CLI's, mixed K
# blocks on the fused members, one member unmapped, non-block schemes
SPECS = [
    [(r"(attn/w[qkvo]|(ffn|moe)/(gate|up|down))/w", "block", (16, 16))],
    [(r"attn/wq/w", "block", (16, 16)), (r"attn/w[kv]/w", "block", (32, 16)),
     (r"ffn/(gate|up)/w", "block", (8, 16))],
    [(r"attn/w[qk]/w", "block", (16, 16)), (r"ffn/gate/w", "block_row",
                                            (16, 8))],
    [(r"attn/.*", "unstructured", (1, 1)), (r"ffn/.*", "pattern", (3, 3))],
    [(r"attn/wq/w", "block_col", (64, 16)), (r"attn/w[kv]/w", "block",
                                             (64, 128)),
     (r"ffn/gate/w", "block", (8, 8)), (r"ffn/up/w", "none", (1, 1))],
]
GRID = list(itertools.product((1, 4, 100, 128, 129, 512, 4096),
                              (64, 256, 1024, 8192, 28672),
                              (128, 512, 1000, 1024, 28672)))


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_fusions_equals_reference(arch):
    for smoke in (False, True):
        for tokens in TOKENS:
            got = F.plan_fusions(configs.get(arch, smoke=smoke), tokens)
            want = ref_F.plan_fusions(ref_configs.get(arch, smoke=smoke),
                                      tokens)
            assert (got.groups, got.saved_hbm_reads) == (
                want.groups, want.saved_hbm_reads)
            # mamba2 has neither heads nor an FFN: nothing to fuse
            assert bool(got.groups) == (arch != "mamba2-1.3b")


@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_fusion_legal_equals_reference(spec):
    rules = SPECS[spec]
    ports = [(p, RW.SchemeChoice(s, b)) for p, s, b in rules]
    refs = [(p, ref_RW.SchemeChoice(s, b)) for p, s, b in rules]
    seen = set()
    for arch in ARCHS:
        for group in F.plan_fusions(configs.get(arch), 128).groups:
            for prefix in ("layers/", "dec/x", "groups/selfs/", ""):
                paths = [prefix + p for p in group]
                got = F.fusion_legal(ports, paths)
                assert got == ref_F.fusion_legal(refs, paths), paths
                seen.add(got)
    if spec == 0:
        assert seen == {True}


def test_fusion_legal_outcomes():
    """Shared K block fuses; differing K blocks or an unmapped member do
    not; non-block schemes never constrain."""
    qkv = ("attn/wq/w", "attn/wk/w", "attn/wv/w")
    ok = [(r"attn/w[qkv]/w", RW.SchemeChoice("block", (16, 16)))]
    assert F.fusion_legal(ok, qkv)
    mixed = [(r"attn/wq/w", RW.SchemeChoice("block", (16, 16))),
             (r"attn/w[kv]/w", RW.SchemeChoice("block", (32, 16)))]
    assert not F.fusion_legal(mixed, qkv)
    assert not F.fusion_legal(ok[:0], qkv)
    free = [(r"attn/", RW.SchemeChoice("unstructured", (1, 1)))]
    assert F.fusion_legal(free, qkv)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_fuse_weights_equals_reference_bitwise(dtype):
    from repro_torch.convert import tensor_from_numpy
    rng = np.random.RandomState(0)
    ws = [rng.randn(64, n).astype(np.float32) for n in (64, 32, 32)]
    ref_ws = [jnp.asarray(w, dtype=jnp.bfloat16 if dtype == "bfloat16"
                          else jnp.float32) for w in ws]
    want = np.asarray(ref_F.fuse_weights(ref_ws))
    got = F.fuse_weights(tensor_from_numpy(np.asarray(w), "cpu")
                         for w in ref_ws)
    assert tuple(got.shape) == want.shape == (64, 128)
    assert torch.equal(got, tensor_from_numpy(want, "cpu"))
    stacked = F.fuse_weights([torch.ones(3, 8, 16), torch.zeros(3, 8, 4)])
    assert tuple(stacked.shape) == (3, 8, 20)


@pytest.mark.parametrize("dtype_bytes", [1, 2, 4])
def test_tile_candidates_equal_reference(dtype_bytes):
    for M, K, N in GRID:
        assert list(AT.tile_candidates(M, K, N, dtype_bytes)) == list(
            ref_AT.tile_candidates(M, K, N, dtype_bytes)), (M, K, N)


@pytest.mark.parametrize("density", [1.0, 0.4, 0.05])
def test_tune_tiles_equals_reference(density):
    picked = set()
    for M, K, N in GRID:
        for dtype_bytes in (1, 2):
            got = AT.tune_tiles(M, K, N, density, dtype_bytes=dtype_bytes)
            want = ref_AT.tune_tiles(M, K, N, density,
                                     dtype_bytes=dtype_bytes)
            assert got == want, (M, K, N, dtype_bytes)
            picked.add(got[0])
    assert len(picked) > 1 and None in picked
