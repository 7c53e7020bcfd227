"""The vision-LM family (llama-3.2-vision-90b SMOKE: 2 groups of 4 self
layers and one gated cross-attention layer) against the reference, fp32
on the CPU, every cross ``gate`` set to 1.0 on both packages' trees (the
reference initialises it to 0, and tanh(0) = 0 would let a wrong
cross-attention pass): the params tree, ``forward`` (dense and compiled,
each group's (G, k - 1) self stack and packed layouts sliced twice),
``prefill``'s logits and caches ("kv_self" over the G * (k - 1) self
layers, "xk"/"xv" of the image patches), one ``decode_step``,
``init_cache``, greedy ``generate`` tokens (dense and packed), the
compiled layouts leaf for leaf, ``forward_aux``'s loss and grads, and
``lm_layers`` with its dead cross-attention rule (the helpers of
``test_torch_encdec.py``)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

from test_torch_encdec import (B, S, decode_step_matches,  # noqa: E402
                               forward_matches, generate_matches,
                               init_cache_matches, layouts_match,
                               lm_layers_match, loss_and_grads_match, model,
                               prefill_matches, robustness_walks,
                               structure, xattn_rule_is_dead)

ARCH = "llama-3.2-vision-90b"


def test_params_tree_matches_port_init_structure():
    own = structure(ARCH)
    assert own["groups/selfs/attn/wq/w"].shape == (2, 4, 64, 64)
    assert own["groups/cross/xattn/wk/w"].shape == (2, 64, 32)
    assert own["groups/cross/gate"].shape == (2, 1)
    assert own["groups/cross/gate"].dtype == torch.float32
    assert float(own["groups/cross/gate"].abs().max()) == 0.0


def test_layer_params_slice_group_then_self_layer():
    """Tensors and packed layouts alike: group g's self layer j is stack
    entry (g, j), its cross layer entry g."""
    m = model(ARCH)
    for tree in (m["pexec"], T.init_lm(m["pcfg"], seed=1, device="cpu")):
        groups = T.layer_params(tree, "groups")
        assert len(groups) == 2
        for g, gp in enumerate(groups):
            selfs = T.layer_params(gp, "selfs")
            assert len(selfs) == 4
            for j, lp in enumerate(selfs):
                want = M.take_layer(M.take_layer(tree["groups"]["selfs"], g),
                                    j)
                for name in ("wq", "wo"):
                    got, ref = lp["attn"][name], want["attn"][name]
                    if "packed" in got:
                        got, ref = got["packed"], ref["packed"]
                        assert got.nnz.shape == ref.nnz.shape == (4,)
                        assert torch.equal(got.nnz, tree["groups"]["selfs"][
                            "attn"][name]["packed"].nnz[g, j])
                    else:
                        assert torch.equal(got["w"], tree["groups"]["selfs"][
                            "attn"][name]["w"][g, j])
            assert gp["cross"]["gate"].shape == (1,)


def test_forward_logits_match_reference_dense_and_compiled():
    forward_matches(ARCH)


def test_the_cross_gate_reaches_the_logits():
    """With the gates at 1 the image patches move the logits; with the
    reference's zero gates they cannot."""
    m = model(ARCH)
    pt = torch.from_numpy(m["tokens"])
    pf = torch.from_numpy(m["frontend"])
    a = T.forward(m["pexec"], m["pcfg"], pt, frontend=pf)
    b = T.forward(m["pexec"], m["pcfg"], pt, frontend=pf.flip(1) * 3)
    assert (a - b).abs().max() > 1e-3 * a.abs().max()
    cross = dict(m["pexec"]["groups"]["cross"])
    cross["gate"] = torch.zeros_like(cross["gate"])
    shut = dict(m["pexec"], groups=dict(m["pexec"]["groups"], cross=cross))
    assert torch.equal(T.forward(shut, m["pcfg"], pt, frontend=pf),
                       T.forward(shut, m["pcfg"], pt, frontend=pf * 3))


def test_prefill_logits_and_caches_match_reference():
    cache = prefill_matches(ARCH, ("kv_self", "xk", "xv"))
    assert tuple(cache["kv_self"]["k"].shape) == (8, B, S, 2, 16)
    assert tuple(cache["xk"].shape) == (2, B, 16, 2, 16)


def test_decode_step_matches_reference():
    decode_step_matches(ARCH)


def test_init_cache_matches_reference_layout():
    got = init_cache_matches(ARCH)
    assert set(got) == {"kv_self/k", "kv_self/v", "kv_self/pos", "xk", "xv"}


def test_generate_tokens_identical_to_reference():
    generate_matches(ARCH)


def test_compiled_layouts_equal_reference_leaf_for_leaf():
    """Every self-attention, cross-attention and FFN projection packs: 7
    self stacks of (G, k - 1) layers and 7 cross stacks of G."""
    got = layouts_match(ARCH, 14)
    assert got["groups/selfs/ffn/down"].nnz.shape[:2] == (2, 4)
    assert got["groups/cross/xattn/wv"].nnz.shape[:1] == (2,)


def test_forward_aux_loss_and_grads_match_reference():
    g = loss_and_grads_match(ARCH)
    assert float(g["groups/cross/gate"].abs().max()) > 0
    assert float(g["groups/cross/xattn/wk/w"].abs().max()) > 0


def test_lm_layers_rows_equal_reference():
    rows = lm_layers_match(ARCH)
    assert rows[0].count == 100 and rows[-3].count == 200


def test_the_reference_cross_attention_rule_is_dead_and_copied():
    xattn_rule_is_dead(ARCH)


def test_validate_faults_and_artifacts_walk_the_tree(tmp_path):
    robustness_walks(ARCH, tmp_path)
