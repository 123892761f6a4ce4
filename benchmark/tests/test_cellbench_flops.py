"""Operation and byte counts against hand counts at the cells' shapes."""

from benchmark import flops as F
from benchmark import spec

MISTRAL = spec.config("mistral-7b-v0.3")
MIXTRAL = spec.config("mixtral-8x7b-v0.1")


def test_product_params_by_hand():
    # per layer: q 4096x4096, k and v 4096x1024, o 4096x4096, 3 x 4096x14336
    layer = 4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 14336
    assert F.layer_product_params(MISTRAL, True) == layer == 218_103_808
    assert F.product_params(MISTRAL) == 8 * layer + 4096 * 32768
    # the config file's totals: norms and the embedding beside the products
    p = MISTRAL["parameters"]
    assert p["total"] == (F.product_params(MISTRAL) + p["embedding"]
                          + 8 * 2 * 4096 + 4096)


def test_moe_active_and_total():
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    expert = 3 * 4096 * 14336
    router = 4096 * 8
    assert F.layer_product_params(MIXTRAL, True) == attn + router + 2 * expert
    assert F.layer_product_params(MIXTRAL, False) == attn + router + 8 * expert
    p = MIXTRAL["parameters"]
    assert p["experts_per_layer"] == 8 * expert
    assert p["total"] == (8 * F.layer_product_params(MIXTRAL, False)
                          + 2 * 4096 * 32000 + 8 * 2 * 4096 + 4096)


def test_trained_token_is_6n_plus_causal_attention():
    S = 4095
    n = F.product_params(MISTRAL)
    per_token = F.train_flops(MISTRAL, 1, S) / S
    attn = 12 * 8 * 4096 * (S + 1) / 2
    assert abs(per_token - (6 * n + attn)) < 1e-6 * per_token
    # ~12.1 GFLOP a trained token at (1, 4096)
    assert 12.0e9 < per_token < 12.2e9


def test_forward_token_is_2n_active_plus_attention():
    S = 2048
    got = F.forward_flops(MIXTRAL, 2, S)
    want = 2 * (2 * F.product_params(MIXTRAL, True) * S
                + 4 * 8 * 4096 * S * (S + 1) // 2)
    assert got == want


def test_serving_counts():
    n = F.product_params(MISTRAL)
    assert F.decode_flops(MISTRAL, 0) == 2 * n + 4 * 8 * 4096
    assert F.prefill_flops(MISTRAL, 10) == 10 * 2 * n + 4 * 8 * 4096 * 55


def test_flash_counts_by_hand():
    # at (2, 1023, 16 heads, 128): 2.1 is half of the repo's (4, 1024)
    # figure, 17.2 GFLOP; the backward is 2.5 times the forward (the
    # kernels execute 12.87 + 17.16 GFLOP, seven products a pair)
    pairs = 2 * 16 * 1023 * 1024 // 2
    assert F.flash_fwd_flops(2, 1023, 16, 128) == 4 * 128 * pairs
    assert F.flash_bwd_flops(2, 1023, 16, 128) == 10 * 128 * pairs
    assert F.flash_bwd_flops(2, 1023, 16, 128) == \
        F.flash_fwd_flops(2, 1023, 16, 128) * 5 // 2
    assert abs(F.flash_bwd_flops(2, 1023, 16, 128) / 1e9
               - (12.87 + 17.16) * 5 / 7) < 0.01
    q = 1 * 4095 * 32 * 128
    kv = 1 * 4095 * 8 * 128
    assert F.flash_fwd_bytes(1, 4095, 32, 8, 128) == \
        2 * (2 * q + 2 * kv) + 4 * 32 * 4095
    assert F.flash_bwd_bytes(1, 4095, 32, 8, 128) == \
        2 * (2 * q + 2 * kv) + 8 * 32 * 4095 + 2 * (q + 2 * kv)


def test_bound_takes_the_larger():
    peak = F.PEAK
    assert F.bound_seconds(989e12, 0, peak) == 1.0
    assert F.bound_seconds(0, 3.35e12, peak) == 1.0
    assert F.bound_seconds(989e12, 6.7e12, peak) == 2.0
