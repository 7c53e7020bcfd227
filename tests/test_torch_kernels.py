"""The BCS block-sparse matmul: the port's wrapper (its plain version on
CPU tensors) against the reference's Pallas kernel in interpret mode, on
the same layouts.  The CUDA kernel itself is held against the plain
version on the card in ``test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import bsr_matmul as ref_bsr  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.convert import layout_from_numpy, tensor_from_numpy  # noqa: E402,E501
from repro_torch.kernels import bsr_matmul as K  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

from test_torch_reference import block_case, ref_to_numpy  # noqa: E402

ACTS = ["none", "silu", "relu"]


def _case(M, block=(16, 16), reorder=True, n_bins=4, seed=0):
    w, mask = block_case(128, 192, block, seed=seed)
    lay = ref_ops.pack(w, mask, block, reorder=reorder, n_bins=n_bins,
                       use_cache=False)
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(M, 128).astype(np.float32)
    b = rng.randn(192).astype(np.float32)
    return lay, x, b, w * mask


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("M", [1, 4, 129])
def test_plain_packed_matches_reference_kernel(M, act):
    lay, x, b, _ = _case(M)
    want = np.asarray(ref_bsr.bsr_matmul_packed(
        jnp.asarray(x), lay, bias=jnp.asarray(b), act=act))
    port = layout_from_numpy(ref_to_numpy(lay), "cpu")
    got = K.bsr_matmul_packed(tensor_from_numpy(x, "cpu"), port,
                              bias=tensor_from_numpy(b, "cpu"), act=act)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert K.LAUNCHES["bsr_matmul"] == 0      # CPU: no kernel launched


@pytest.mark.parametrize("block", [(16, 16), (8, 16), (4, 4)])
def test_reordered_equals_unreordered_bitwise(block):
    w, mask = block_case(128, 192, block, seed=5)
    wt, mt = tensor_from_numpy(w, "cpu"), tensor_from_numpy(mask, "cpu")
    x = torch.from_numpy(np.random.RandomState(6).randn(7, 128)
                         .astype(np.float32))
    b = torch.from_numpy(np.random.RandomState(7).randn(192)
                         .astype(np.float32))
    plain = ops.pack(wt, mt, block)
    ys = [K.bsr_matmul_packed(x, plain, bias=b, act="silu")]
    for n_bins in (1, 2, 4):
        lay = ops.pack(wt, mt, block, reorder=True, n_bins=n_bins)
        ys.append(K.bsr_matmul_packed(x, lay, bias=b, act="silu"))
    for y in ys[1:]:
        assert torch.equal(y, ys[0])
    dense = ref.masked_matmul_ref(x, wt, mt, bias=b, act="silu")
    torch.testing.assert_close(ys[0], dense, rtol=1e-5, atol=1e-5)


def test_layout_helpers_match_reference():
    lay, _, b, _ = _case(4, n_bins=3)
    port = layout_from_numpy(ref_to_numpy(lay), "cpu")
    for p, r in zip(port.bin_bias(tensor_from_numpy(b, "cpu")),
                    lay.bin_bias(jnp.asarray(b))):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    y = np.random.RandomState(2).randn(3, 192).astype(np.float32)
    np.testing.assert_array_equal(
        port.unpermute_cols(torch.from_numpy(y)).numpy(),
        np.asarray(lay.unpermute_cols(jnp.asarray(y))))
    assert port.L_max == lay.L_max
    assert port.L_effective == pytest.approx(lay.L_effective)
    assert port.density == pytest.approx(lay.density)


def test_single_bin_launch_matches_reference_oracle():
    """The reference's single-bin kernel against the port's packed entry on
    a one-bin layout, and against the port's single-bin plain version."""
    lay, x, b, _ = _case(5, reorder=False)
    assert lay.n_bins == 1
    vals, kidx = lay.values[0], lay.k_idx[0]
    want = np.asarray(ref_bsr.bsr_matmul(jnp.asarray(x), vals, kidx,
                                         bias=jnp.asarray(b), act="relu"))
    xt, bt = tensor_from_numpy(x, "cpu"), tensor_from_numpy(b, "cpu")
    port = layout_from_numpy(ref_to_numpy(lay), "cpu")
    got = K.bsr_matmul_packed(xt, port, bias=bt, act="relu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = ref.bsr_matmul_ref(xt, port.values[0], port.k_idx[0], bias=bt,
                               act="relu")
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_other_devices():
    lay, x, _, _ = _case(2, reorder=False)
    port = layout_from_numpy(ref_to_numpy(lay), "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.bsr_matmul_packed(tensor_from_numpy(x, "meta"), port)


def test_uniform_to_dense_matches_reference():
    from repro.kernels import ref as ref_ref
    lay, _, _, wm = _case(3, reorder=False)
    vals, kidx = lay.values[0], lay.k_idx[0]
    got = ref.uniform_to_dense(tensor_from_numpy(vals, "cpu"),
                               tensor_from_numpy(kidx, "cpu"), 128)
    want = np.asarray(ref_ref.uniform_to_dense(vals, kidx, 128))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), wm)


def test_packed_rejects_mismatched_k():
    lay, x, _, _ = _case(2)
    port = layout_from_numpy(ref_to_numpy(lay), "cpu")
    with pytest.raises(ValueError, match="K="):
        K.bsr_matmul_packed(tensor_from_numpy(x, "cpu")[:, :64], port)
