"""The cost tables against hand counts, and the masks they come from."""
import pytest
import torch

from perfbench import costs, weights

from conftest import tiny_conf


def test_prune_zeroes_dead_blocks_and_counts_live(bench):
    conf = tiny_conf(bench, "yi-9b")
    params, masks, live = weights.draw(conf, 123, "cpu")
    bk, bn = conf["scheme"]["block"]
    for path, ent in live.items():
        *_, leaf, _ = path.split("/")
        w = params["layers"]["attn" if leaf.startswith("w") else "ffn"][
            leaf]["w"]
        m = masks["layers"]["attn" if leaf.startswith("w") else "ffn"][
            leaf]["w"]
        assert not bool((w[~m] != 0).any())
        n, K, N = w.shape
        blocks = m.view(n, K // bk, bk, N // bn, bn).any(4).any(2)
        assert torch.equal(blocks.sum((1, 2)), ent["blocks"])
        # the rate is over the whole stacked leaf
        dead = 1 - blocks.float().mean()
        assert dead == pytest.approx(conf["scheme"]["rate"], abs=1.0 / (
            blocks.numel()) + 1e-6)


def _one_layer_model(expert):
    live = {}
    m = {"num_hidden_layers": 1, "hidden_size": 32, "head_dim": 8,
         "num_attention_heads": 4, "vocab_size": 100}
    if expert:
        m.update(num_local_experts=2, num_experts_per_tok=2)
    for p in ("wq", "wk", "wv", "wo"):
        live[f"layers/attn/{p}/w"] = {"blocks": torch.tensor([3]),
                                      "shape": (32, 32), "block": (16, 16)}
    ffn = "moe" if expert else "ffn"
    for p, shape in (("gate", (32, 64)), ("up", (32, 64)),
                     ("down", (64, 32))):
        blocks = torch.tensor([[5, 7]]) if expert else torch.tensor([6])
        live[f"layers/{ffn}/{p}/w"] = {"blocks": blocks, "shape": shape,
                                       "block": (16, 16)}
    return costs.Model(m, live)


def test_launch_by_hand():
    model = _one_layer_model(False)
    f, b = model.launch("layers/attn/wq/w", 0, rows=4)
    assert f == 2 * 4 * 3 * 256
    assert b == 3 * (256 * 2 + 4) + 4 * (32 + 32) * 2
    f, b = model.launch("layers/ffn/down/w", 0, rows=4)
    assert f == 2 * 4 * 6 * 256
    assert b == 6 * (256 * 2 + 4) + 4 * (64 + 32) * 2


def test_expert_launch_by_hand():
    model = _one_layer_model(True)
    # 4 tokens, top-2: 8 pairs at the mean of 5 and 7 live blocks
    f, b = model.launch("layers/moe/gate/w", 0, rows=8)
    assert f == 2 * 8 * 6 * 256
    assert b == 12 * (256 * 2 + 4) + 8 * (32 + 64) * 2
    assert model.k1_flops(4) == pytest.approx(
        4 * 2 * 4 * 3 * 256 + 3 * 2 * 8 * 6 * 256)


def test_step_flops_by_hand():
    model = _one_layer_model(False)
    rings = [10, 20]
    want = model.k1_flops(2) + 4 * 4 * 8 * 30 + 2 * 2 * 32 * 100
    assert model.decode_flops(rings) == pytest.approx(want)
    P = 6
    want = model.k1_flops(P) + 4 * 4 * 8 * P * (P + 1) / 2 + 2 * 32 * 100
    assert model.prefill_flops(P) == pytest.approx(want)
    moe = _one_layer_model(True)
    assert moe.decode_flops([5]) == pytest.approx(
        moe.k1_flops(1) + 4 * 4 * 8 * 5 + 2 * 32 * 2 + 2 * 32 * 100)


def test_bound_takes_the_larger_term():
    model = _one_layer_model(False)
    s = 0.0
    for path, _ in model.projections():
        f, b = model.launch(path, 0, 16)
        s += max(f / costs.PEAK_FLOPS, b / costs.PEAK_BYTES)
    assert model.k1_bound(16) == pytest.approx(s)
