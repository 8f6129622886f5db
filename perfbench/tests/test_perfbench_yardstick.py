"""The FLOP counts and K2's bytes against hand counts at small shapes."""

import pytest

from perfbench.harness import yardstick as Y
from perfbench.harness.context import Run, Served

SMALL = {"backbone": "se_vgg", "emb_dim": 8, "enc_ffn_dim": 16, "dec_ffn_dim": 32, "enc_layers": 1, "dec_layers": 1,
         "vocab_size": 5, "num_heads": 2, "use_bilstm": True}


def test_union():
    assert Y.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert Y.union([]) == 0.0


def test_conv_flops_by_hand():
    assert Y.conv_flops(2, 3, 3, 4, 5) == 2 * 2 * 3 * 9 * 20


def test_se_vgg_chunk_by_hand():
    hand = (2 * 1 * 64 * 9 * 48 * 100 + 2 * 64 * 128 * 9 * 24 * 50 + 2 * 128 * 256 * 9 * 12 * 25
            + 2 * 256 * 256 * 9 * 12 * 25 + 2 * 25 * 2 * 256 * 16
            + 2 * 256 * 512 * 9 * 6 * 25 + 2 * 512 * 512 * 9 * 6 * 25 + 2 * 25 * 2 * 512 * 32
            + 2 * 512 * 512 * 9 * 3 * 25 + 2 * 25 * 2 * 512 * 32)
    assert Y.backbone_flops({"backbone": "se_vgg"}) == hand


def test_resnet_chunk_by_hand():
    c = Y.conv_flops
    hand = (c(1, 64, 3, 48, 100) + c(64, 128, 3, 24, 50) + c(128, 128, 3, 24, 50) + c(64, 128, 1, 24, 50)
            + c(128, 256, 3, 12, 25) + c(256, 256, 3, 12, 25) + c(128, 256, 1, 12, 25) + 2 * c(256, 256, 3, 12, 25)
            + c(256, 512, 3, 6, 25) + c(512, 512, 3, 6, 25) + c(256, 512, 1, 6, 25) + 2 * c(512, 512, 3, 6, 25)
            + 2 * c(512, 512, 3, 3, 25))
    assert Y.backbone_flops({"backbone": "resnet"}) == hand
    assert 5.0e9 < hand < 5.1e9


def test_encode_and_decode_by_hand():
    m = SMALL
    d, t = 8, 32
    enc = 2 * t * 1024 * d + (4 * 2 * t * d * d + 2 * 2 * t * t * d + 2 * 2 * t * d * 16)
    chunk = Y.backbone_flops(m) + enc
    lstm = 2 * (2 * t) * (2 * d * 4 * 4 + 2 * 4 * 4 * 4)  # two directions over the line's 64 tokens, H = 4
    assert Y.line_encode_flops(m, 2) == 2 * chunk + lstm + 2 * 2 * (2 * t) * d * d
    # one step at pos 0 over 32 memory rows: qkv, self attention over 1 slot, 3 d x d products, cross attention, FFN
    step = 2 * d * 3 * d + 4 * 1 * d + 3 * 2 * d * d + 4 * 32 * d + 2 * 2 * d * 32 + 2 * d * 5
    assert Y.decode_step_flops(m, 0, 32) == step
    assert Y.line_decode_flops(m, 1, 3, 32) == 3 * step


def test_k2_bytes_and_ops_by_hand():
    d, f = 4, 8
    numel = Y.k2_layer_numel(d, f)
    assert numel == 3 * d * d + 3 * d * d + 2 * d * f + 13 * d + f
    nbytes, ops = Y.k2_cost(n_img=2, lanes=3, d=d, f=f, heads=2, pos=5, tm=64, tm_valid=40, pairs=10,
                            weights_numel=numel, beam=True)
    b = 6
    assert nbytes == 4 * (numel + 4 * b * d + 2 * 10 * d + 2 * 40 * d + 2 * 64 + b * 5)
    attn = 4 * b * 6 * d + 4 * 3 * 40 * d + 6 * 2 * (b * 6 + 3 * 40)
    assert ops == 2 * b * (6 * d * d + 2 * d * f) + attn + 30 * b * d


def test_bound_is_the_larger_of_bytes_and_operations():
    assert Y.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert Y.bound_s(1.0, 67e12) == pytest.approx(1.0)
    assert Y.bound_s(1.0, 989e12, itemsize=2) == pytest.approx(1.0)


def test_k2_least_time_counts_the_batches_the_predictor_forms():
    m = {"emb_dim": 4, "dec_ffn_dim": 8, "num_heads": 2, "dec_layers": 2}
    served = [Served(3, [2, 2, 5], [2, 1, 1], 0.1)]
    run = Run({}, {"model": m}, 0.0, 1.0, served, counters={"lanes": 1, "chunk_buckets": [1, 2, 3, 4, 6, 8],
                                                            "batch_size": 8})
    assert Y.decode_batches(served, [1, 2, 3, 4, 6, 8], 8) == [(2, 2, [(2, 2), (2, 1)]), (1, 6, [(5, 1)])]
    numel = Y.k2_layer_numel(4, 8)
    want = 0.0
    for n, bucket, tm_valid, steps in ((2, 2, 128, 2), (1, 6, 160, 1)):
        for pos in range(steps):
            want += 2 * Y.bound_s(*Y.k2_cost(n, 1, 4, 8, 2, pos, bucket * 32, tm_valid, n * pos, numel, False))
    assert Y.k2_least_s(run) == pytest.approx(want)
