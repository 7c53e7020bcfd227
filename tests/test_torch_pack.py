"""The port's packer against the reference's, leaf for leaf: single
layouts (``kernels.ops.pack``), magnitude block masks, and the stacked
layouts and report rows of ``serve.compile.compile_model``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import reweighted as ref_RW  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.serve import compile as ref_compile  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core import bcs  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.train.trainer import apply_masks  # noqa: E402

from test_torch_reference import (SPEC_RE, assert_layout_equal,  # noqa: E402
                                  block_case, ref_smoke_params, ref_to_numpy,
                                  to_port)

BINNING = [(False, 1), (True, 1), (True, 2), (True, 4)]
BLOCKS = [(16, 16), (8, 16), (4, 4)]


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("reorder,n_bins", BINNING)
def test_pack_matches_reference(reorder, n_bins, block, dtype):
    w, mask = block_case(96, 128, block, seed=sum(block) + n_bins)
    w = np.asarray(jnp.asarray(w, dtype))
    ref = ref_ops.pack(w, mask, block, reorder=reorder, n_bins=n_bins,
                       use_cache=False)
    port = ops.pack(tensor_from_numpy(w, "cpu"),
                    tensor_from_numpy(mask, "cpu"), block, reorder=reorder,
                    n_bins=n_bins)
    assert_layout_equal(port, ref)
    assert port.executed_blocks == ref.executed_blocks
    assert port.nnzb == ref.nnzb
    assert port.padding_overhead == pytest.approx(ref.padding_overhead)
    assert ops.flops_saved(port) == pytest.approx(ref_ops.flops_saved(ref))
    assert torch.equal(port.to_dense(),
                       tensor_from_numpy(np.asarray(ref.to_dense()), "cpu"))


def test_bin_bounds_match_reference():
    from repro.core import bcs as ref_bcs
    for nb in (1, 3, 4, 7, 32, 688):
        for n in (1, 2, 4, 8):
            assert bcs.bin_bounds(nb, n) == ref_bcs.bin_bounds(nb, n)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_magnitude_masks_and_compiled_layouts_match_reference(dtype):
    """Whole-stack quantile masks are equal, and so is every stacked,
    L-padded layout and report row ``compile_model`` produces."""
    _, _, rparams = ref_smoke_params(dtype, d_ff=192)
    spec = [(SPEC_RE, ref_RW.SchemeChoice("block", (16, 16)))]
    pspec = [(SPEC_RE, RW.SchemeChoice("block", (16, 16)))]
    rmasks = ref_RW.magnitude_block_masks(rparams, spec, None, rate=0.6)
    pparams = to_port(rparams)
    pmasks = RW.magnitude_block_masks(pparams, pspec, None, rate=0.6)
    rflat, pflat = ref_to_numpy(rmasks), pmasks

    def compare(r, p):
        if isinstance(r, dict):
            for k in r:
                compare(r[k], p[k])
            return
        np.testing.assert_array_equal(np.asarray(r) != 0, p.numpy() != 0)
    compare(rflat, pflat)

    rpm = ref_apply_masks(rparams, rmasks)
    rexec, rrep = ref_compile.compile_model(
        rpm, rmasks, spec, spec=ref_compile.CompileSpec(keep_dense=False))
    pexec, prep = C.compile_model(
        apply_masks(pparams, pmasks), pmasks, pspec,
        spec=C.CompileSpec(keep_dense=False), device="cpu")

    def rows(rep):
        return [(r.path, r.packed, r.L, r.L_reordered, r.Kb, r.layers)
                for r in rep]
    assert rows(prep) == rows(rrep)
    for r, p in zip(rrep, prep):
        if r.packed:
            assert p.density == pytest.approx(r.density)
            assert p.flops_saved == pytest.approx(r.flops_saved)
    n_packed = 0
    for name in ("wq", "wk", "wv", "wo"):
        assert "w" not in pexec["layers"]["attn"][name]
        assert_layout_equal(pexec["layers"]["attn"][name]["packed"],
                            rexec["layers"]["attn"][name]["packed"])
        n_packed += 1
    for name in ("gate", "up", "down"):
        assert_layout_equal(pexec["layers"]["ffn"][name]["packed"],
                            rexec["layers"]["ffn"][name]["packed"])
        n_packed += 1
    assert n_packed == len(prep.packed) == 7
    assert C.compiled_summary(prep) == ref_compile.compiled_summary(rrep)


def test_compile_skips_what_it_cannot_pack():
    _, _, rparams = ref_smoke_params()
    pparams = to_port(rparams)
    spec = [(r"attn/wq/w", RW.SchemeChoice("block", (48, 48))),   # 48 ∤ 64
            (r"ffn/gate/w", RW.SchemeChoice("none"))]
    masks = RW.magnitude_block_masks(
        pparams, [(r"attn/wq/w", RW.SchemeChoice("block", (16, 16)))],
        (16, 16), rate=0.5)
    _, rep = C.compile_model(pparams, masks, spec, device="cpu")
    by_path = {r.path: r for r in rep}
    assert "does not divide" in by_path["layers/attn/wq/w"].reason
    assert by_path["layers/ffn/gate/w"].reason == "no block scheme mapped"
    assert not rep.packed
