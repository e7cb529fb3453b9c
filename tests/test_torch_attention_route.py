"""CPU checks of the attention kernels' static choices: which flash kernel
a call takes (`flash_attention.kernel.route`), how the decode kernel
splits the cache (`decode_attention.kernel.default_chunk`), and the bf16
split of the probabilities that the decode kernel's tensor-core product
takes. The kernels themselves run only on the card
(`tests/test_torch_cuda.py`)."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as DK  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402

# the archs with attention layers (xlstm-350m has none)
ATTN_ARCHS = [a for a in list_archs()
              if any(b.kind == "attn" for b in get_config(a).pattern)]


def test_every_attention_arch_is_listed():
    assert len(ATTN_ARCHS) == 9
    assert {get_config(a).attn.head_dim for a in ATTN_ARCHS} == \
        {64, 96, 120, 128}


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_every_arch_takes_the_tensor_core_kernels_in_bf16(arch):
    """bf16 prefill takes the wgmma flash kernel at every arch's head
    dim, float32 the split-TF32 one; the decode kernel takes every arch's
    grouping and head dim."""
    a = get_config(arch).attn
    assert FK.route(torch.bfloat16, a.head_dim) == "wgmma"
    assert FK.route(torch.float32, a.head_dim) == "tf32x3"
    assert a.num_heads % a.num_kv_heads == 0
    assert a.num_heads // a.num_kv_heads <= DK.MAX_GROUP
    assert a.head_dim <= DK.MAX_HEAD_DIM and a.head_dim % 8 == 0


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 120, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 100, "simt"),     # not a multiple of 8
    (torch.bfloat16, 4, "simt"),
    (torch.bfloat16, 136, "simt"),     # wider than the kernels take
    (torch.float32, 64, "tf32x3"),
    (torch.float32, 128, "tf32x3"),
    (torch.float32, 16, "tf32x3"),     # the reduced configs' head dim
    (torch.float32, 20, "simt"),       # not a multiple of 8
    (torch.bfloat16, 20, "simt"),
    (torch.float32, 136, "simt"),
    (torch.float16, 128, "simt"),
])
def test_route_is_a_rule_of_dtype_and_head_dim(dtype, hd, want):
    assert FK.route(dtype, hd) == want


@pytest.mark.parametrize("B,K,T", [
    (8, 8, 1056), (1, 1, 100), (64, 8, 4096), (2, 2, 100), (8, 8, 64),
    (3, 1, 1000), (1, 8, 32768), (16, 8, 2048), (1, 1, 1), (2, 2, 33),
])
def test_default_chunk_gives_whole_tiles_that_cover_the_cache(B, K, T):
    """Whole tiles, the last split non-empty, and no more blocks than one
    wave of `BLOCKS_PER_SM` on every SM holds (unless one split per
    (batch, KV head) is already more)."""
    chunk = DK.default_chunk(B, K, T)
    n = math.ceil(T / chunk)
    assert chunk % DK.TILE == 0 and chunk >= DK.TILE
    assert (n - 1) * chunk < T <= n * chunk
    assert B * K * n <= DK.BLOCKS_PER_SM * DK.N_SM or n == 1


def test_default_chunk_fills_one_wave_at_the_serving_shape():
    """qwen3-8b decode (batch 8 x 8 KV heads, 1,056 slots): one more split
    per (batch, KV head) would overfill the wave of `BLOCKS_PER_SM`
    blocks on every SM, and every SM gets at least one block."""
    B, K, T = 8, 8, 1056
    n = math.ceil(T / DK.default_chunk(B, K, T))
    assert DK.N_SM <= B * K * n <= DK.BLOCKS_PER_SM * DK.N_SM \
        < B * K * (n + 1)


def test_bf16_split_of_the_probabilities_keeps_float32_rounding():
    """The decode kernel's P V on the tensor cores takes P as a bf16 part
    and a bf16 remainder: a plain model of it is within 2^-17 of the
    float32 P V, relative to sum |p v| (the remainder leaves at most
    2^-18 of each p), where the bf16 part alone is not within 2^-13."""
    g = torch.Generator().manual_seed(0)
    p = torch.rand(64, 1024, generator=g)
    v = torch.randn(1024, 128, generator=g).bfloat16().double()
    hi = p.bfloat16().double()
    lo = (p - p.bfloat16().float()).bfloat16().double()
    want = p.double() @ v
    scale = p.double().abs() @ v.abs()
    assert float(((hi @ v + lo @ v - want).abs() / scale).max()) < 2 ** -17
    assert float(((hi @ v - want).abs() / scale).max()) > 2 ** -13
