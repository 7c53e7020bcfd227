"""The port's model and serving path against the reference, at yi-9b SMOKE
size, fp32 unless stated: layer primitives, attention, ``forward``,
``prefill``'s cache, and greedy ``generate`` tokens for dense and
compiled (``keep_dense=False``) params.  The reference runs as its own
tests run it (Pallas kernels in interpret mode)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import reweighted as ref_RW  # noqa: E402
from repro.models import attention as ref_A  # noqa: E402
from repro.models import layers as ref_L  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serve import compile as ref_compile  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

from test_torch_reference import SPEC_RE, ref_smoke_params, to_port  # noqa: E402,E501

RTOL = ATOL = 2e-4          # the bound tests/test_sparse_exec.py uses


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(port, ref, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol)


# -- primitives ----------------------------------------------------------------

def test_rmsnorm_matches_reference():
    x, s = _np(0, 2, 5, 64), _np(1, 64)
    _close(L.rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x)),
           ref_L.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x)))


@pytest.mark.parametrize("pos_shape", ["shared", "per_row"])
def test_rotary_matches_reference(pos_shape):
    x = _np(2, 3, 6, 4, 16)
    pos = (np.arange(6, dtype=np.int32) + 40 if pos_shape == "shared"
           else np.array([[7], [8], [9]], np.int32))
    if pos_shape == "per_row":
        x = x[:, :1]
    _close(L.apply_rotary(torch.from_numpy(x), torch.from_numpy(pos)),
           ref_L.apply_rotary(jnp.asarray(x), jnp.asarray(pos)), atol=1e-4)


@pytest.mark.parametrize("kv_chunk", [64, 4])
@pytest.mark.parametrize("window", [0, 5])
def test_attend_matches_reference(kv_chunk, window):
    """Single-chunk and KV-chunked online softmax, causal, with and
    without a sliding window."""
    q, k, v = _np(3, 2, 16, 4, 8), _np(4, 2, 16, 4, 8), _np(5, 2, 16, 4, 8)
    pos = np.arange(16, dtype=np.int32)
    got = A.attend(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)),
                   window=window, kv_chunk=kv_chunk)
    want = ref_A.attend(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                        window=window, kv_chunk=kv_chunk)
    _close(got, want)


def test_attend_cached_matches_reference():
    """Batch-shared positions over a ring whose slots hold positions out of
    order, some after the query (masked out)."""
    q, kc, vc = _np(6, 2, 1, 2, 2, 8), _np(7, 2, 10, 2, 8), _np(8, 2, 10, 2, 8)
    k_pos = np.array([10, 11, 12, 3, 4, 5, 6, 7, 8, 9], np.int32)
    q_pos = np.array([11], np.int32)
    got = A.attend_cached(*(torch.from_numpy(a)
                            for a in (q, kc, vc, q_pos, k_pos)))
    want = ref_A.attend_cached(*(jnp.asarray(a)
                                 for a in (q, kc, vc, q_pos, k_pos)))
    _close(got, want)


def test_expand_kv_reads_kv_head_h_over_g():
    k = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    e = A._expand_kv(k, 6)
    for h in range(6):
        assert torch.equal(e[:, :, h], k[:, :, h // 3])
    q = torch.arange(6 * 4, dtype=torch.float32).reshape(1, 1, 6, 4)
    assert torch.equal(A._grouped(q, 2)[0, 0, 1, 2], q[0, 0, 5])


# -- whole model ---------------------------------------------------------------

def _masked(dtype=jnp.float32):
    """(ref cfg, port cfg, ref masked params, ref masks) with the serving
    CLI's magnitude block masks at rate 0.6."""
    rcfg, pcfg, rparams = ref_smoke_params(dtype)
    spec = [(SPEC_RE, ref_RW.SchemeChoice("block", (16, 16)))]
    masks = ref_RW.magnitude_block_masks(rparams, spec, None, rate=0.6)
    return rcfg, pcfg, ref_apply_masks(rparams, masks), masks, spec


def _port_compiled(rpm, rmasks):
    pspec = [(SPEC_RE, RW.SchemeChoice("block", (16, 16)))]
    exec_p, rep = C.compile_model(to_port(rpm), to_port(rmasks), pspec,
                                  spec=C.CompileSpec(keep_dense=False),
                                  device="cpu")
    assert len(rep.packed) == 7
    return exec_p


def _tokens(cfg, B, S, seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab, size=(B, S))


def test_forward_logits_match_reference_dense_and_compiled():
    rcfg, pcfg, rpm, rmasks, _ = _masked()
    tokens = _tokens(rcfg, 2, 16)
    want, _ = ref_T.forward(rpm, rcfg, jnp.asarray(tokens))
    dense = T.forward(to_port(rpm), pcfg, torch.from_numpy(tokens))
    packed = T.forward(_port_compiled(rpm, rmasks), pcfg,
                       torch.from_numpy(tokens))
    for got in (dense, packed):
        _close(got, want, rtol=RTOL, atol=ATOL)


def test_prefill_cache_matches_reference():
    """The cache is as long as the prompt: roped K, V per layer and the
    positions 0..S-1 of the ring."""
    rcfg, pcfg, rpm, _, _ = _masked()
    tokens = _tokens(rcfg, 2, 12, seed=3)
    r_logits, r_cache = ref_engine.prefill(rpm, rcfg, jnp.asarray(tokens))
    p_logits, p_cache = engine.prefill(to_port(rpm), pcfg,
                                       torch.from_numpy(tokens))
    _close(p_logits, r_logits, rtol=RTOL, atol=ATOL)
    for name in ("k", "v"):
        assert tuple(p_cache["kv"][name].shape) == (2, 2, 12, 2, 16)
        _close(p_cache["kv"][name], r_cache["kv"][name], rtol=RTOL,
               atol=ATOL)
    np.testing.assert_array_equal(p_cache["kv"]["pos"].numpy(),
                                  np.asarray(r_cache["kv"]["pos"]))


def test_generate_tokens_identical_to_reference():
    """Greedy tokens equal the reference's for dense params and for
    ``compile_model(keep_dense=False)`` params, decoding past the prompt
    length so the ring drops its oldest positions."""
    rcfg, pcfg, rpm, rmasks, spec = _masked()
    tokens = _tokens(rcfg, 2, 8, seed=4)
    rexec, _ = ref_compile.compile_model(
        rpm, rmasks, spec, spec=ref_compile.CompileSpec(keep_dense=False))
    want_dense = np.asarray(ref_engine.generate(rpm, rcfg,
                                                jnp.asarray(tokens), 12))
    want_sparse = np.asarray(ref_engine.generate(rexec, rcfg,
                                                 jnp.asarray(tokens), 12))
    got_dense = engine.generate(to_port(rpm), pcfg, tokens, 12,
                                device="cpu")
    got_sparse = engine.generate(_port_compiled(rpm, rmasks), pcfg, tokens,
                                 12, device="cpu")
    assert got_sparse.shape == (2, 12) and got_sparse.dtype == torch.int32
    np.testing.assert_array_equal(got_dense.numpy(), want_dense)
    np.testing.assert_array_equal(got_sparse.numpy(), want_sparse)
    np.testing.assert_array_equal(got_sparse.numpy(), got_dense.numpy())


def test_bf16_logits_close_to_reference():
    """bf16 rounds at other places in the two frameworks (and the packed
    gate rounds once after its fused silu), so bf16 logits are held to an
    absolute bound of 2e-2 against logits of magnitude ~0.5; the fp32
    tests above are the tight ones."""
    rcfg, pcfg, rpm, rmasks, _ = _masked(jnp.bfloat16)
    tokens = _tokens(rcfg, 2, 16, seed=5)
    want, _ = ref_T.forward(rpm, rcfg, jnp.asarray(tokens))
    packed = T.forward(_port_compiled(rpm, rmasks), pcfg,
                       torch.from_numpy(tokens))
    dense = T.forward(to_port(rpm), pcfg, torch.from_numpy(tokens))
    for got in (dense, packed):
        assert got.dtype == torch.bfloat16
        _close(got, want, rtol=0, atol=2e-2)


def test_decode_step_in_place_ring_matches_reference_step():
    """One decode step at position == cache length writes ring slot 0 and
    gives the reference's logits."""
    rcfg, pcfg, rpm, _, _ = _masked()
    tokens = _tokens(rcfg, 2, 6, seed=6)
    _, r_cache = ref_engine.prefill(rpm, rcfg, jnp.asarray(tokens))
    pp = to_port(rpm)
    _, p_cache = engine.prefill(pp, pcfg, torch.from_numpy(tokens))
    tok = np.array([[3], [7]], np.int32)
    pos = np.full((2, 1), 6, np.int32)
    r_logits, r_cache = ref_T.decode_step(rpm, rcfg, jnp.asarray(tok),
                                          r_cache, jnp.asarray(pos))
    p_logits, p_cache = T.decode_step(pp, pcfg, torch.from_numpy(tok),
                                      p_cache, torch.from_numpy(pos))
    _close(p_logits, r_logits, rtol=RTOL, atol=ATOL)
    assert p_cache["kv"]["pos"][:, 0].tolist() == [6, 6]
    np.testing.assert_array_equal(p_cache["kv"]["pos"].numpy(),
                                  np.asarray(r_cache["kv"]["pos"]))
    _close(p_cache["kv"]["k"], r_cache["kv"]["k"], rtol=RTOL, atol=ATOL)


def test_init_cache_matches_reference_layout():
    rcfg, pcfg, rparams = ref_smoke_params()
    want = ref_T.init_cache(rparams, rcfg, 3, 10)
    got = T.init_cache(to_port(rparams), pcfg, 3, 10)
    for name in ("k", "v", "pos"):
        r = np.asarray(want["kv"][name])
        assert tuple(got["kv"][name].shape) == r.shape
        np.testing.assert_array_equal(got["kv"][name].float().numpy(),
                                      r.astype(np.float32))
    assert got["kv"]["k"].dtype == torch.bfloat16
