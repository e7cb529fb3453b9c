"""Config dataclasses for models, shapes, meshes and runs; a copy of
`repro.configs.base` (pure dataclasses), kept in the port so that it
imports nothing of the JAX package.

Everything is a frozen dataclass so configs are hashable. Architecture
configs live in one module per arch (``repro_torch/configs/<arch>.py``)
and are registered in ``repro_torch.configs``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block-level configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    # sliding window size (tokens) or None for full causal attention
    sliding_window: Optional[int] = None
    causal: bool = True

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    capacity_factor: float = 1.25
    # tokens per dispatch group; smaller groups shrink the dispatch one-hot
    group_size: int = 1024
    router_aux_weight: float = 0.01
    gated: bool = True


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    chunk: int = 256  # selective-scan chunk length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    num_heads: int = 4
    mlstm_expand: int = 2
    slstm_proj_factor: float = 4.0 / 3.0
    chunk: int = 256  # mLSTM chunkwise-parallel chunk length


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One block in the repeating layer pattern."""

    kind: str  # "attn" | "mamba" | "mlstm" | "slstm"
    ff: str = "dense"  # "dense" | "moe" | "none"


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    d_ff: int  # dense-MLP hidden dim (0 if the arch has no dense MLP)
    vocab_size: int
    attn: AttnConfig
    pattern: Tuple[BlockConfig, ...] = (BlockConfig("attn", "dense"),)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # "tokens": integer ids -> embedding table. "embeds": precomputed
    # modality-frontend embeddings (audio frames / vision patches) + labels.
    input_mode: str = "tokens"
    mlp_gated: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    logit_softcap: Optional[float] = None
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # "none" | "full" | "dots"
    # whether long_500k (sub-quadratic path) applies to this arch
    sub_quadratic: bool = False
    # sharding recipe name (see repro.distributed.sharding)
    sharding_recipe: str = "tp"  # "dp" | "tp" | "fsdp_tp"
    notes: str = ""

    def __post_init__(self):
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern length {len(self.pattern)}"
            )
        for blk in self.pattern:
            if blk.ff == "moe" and self.moe is None:
                raise ValueError(f"{self.name}: moe block without MoEConfig")
            if blk.kind == "mamba" and self.mamba is None:
                raise ValueError(f"{self.name}: mamba block without MambaConfig")
            if blk.kind in ("mlstm", "slstm") and self.xlstm is None:
                raise ValueError(f"{self.name}: xlstm block without XLSTMConfig")

    @property
    def num_repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    # ---- parameter counting (for 6ND model flops + memory estimates) ----
    def param_count(self) -> int:
        D = self.d_model
        n = 0
        if self.input_mode == "tokens":
            n += self.vocab_size * D
        else:
            n += D * D  # frontend projection stub
        n += self.vocab_size * D if not self.tie_embeddings else 0
        n += D  # final norm
        for blk in self.pattern:
            n += self.num_repeats * self._block_params(blk)
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: only top-k experts count)."""
        D = self.d_model
        n = 0
        if self.input_mode == "tokens":
            n += self.vocab_size * D
        else:
            n += D * D
        n += self.vocab_size * D if not self.tie_embeddings else 0
        n += D
        for blk in self.pattern:
            n += self.num_repeats * self._block_params(blk, active=True)
        return n

    def _block_params(self, blk: BlockConfig, active: bool = False) -> int:
        D = self.d_model
        n = D  # pre-norm scale
        if blk.kind == "attn":
            a = self.attn
            n += D * a.num_heads * a.head_dim  # wq
            n += 2 * D * a.num_kv_heads * a.head_dim  # wk, wv
            n += a.num_heads * a.head_dim * D  # wo
            if a.qk_norm:
                n += 2 * a.head_dim
        elif blk.kind == "mamba":
            m = self.mamba
            d_in = m.expand * D
            dt_rank = m.dt_rank or math.ceil(D / 16)
            n += D * 2 * d_in  # in_proj
            n += m.d_conv * d_in  # depthwise conv
            n += d_in * (dt_rank + 2 * m.d_state)  # x_proj
            n += dt_rank * d_in + d_in  # dt_proj
            n += d_in * m.d_state + d_in  # A_log, D
            n += d_in * D  # out_proj
        elif blk.kind == "mlstm":
            x = self.xlstm
            d_in = x.mlstm_expand * D
            n += D * 2 * d_in  # up projection (x, gate)
            n += 3 * d_in * d_in  # q, k, v over inner dim
            n += 2 * d_in  # per-channel i/f gate proj (diagonal)
            n += d_in  # group norm
            n += d_in * D  # down proj
        elif blk.kind == "slstm":
            x = self.xlstm
            h = int(x.slstm_proj_factor * D)
            n += 4 * D * D  # recurrent gate projections (i, f, z, o)
            n += 4 * D * D  # input projections
            n += D  # group norm
            n += D * h + h * D  # ffn up/down
        if blk.ff == "dense":
            mult = 3 if self.mlp_gated else 2
            n += D + mult * D * self.d_ff  # norm + mlp
        elif blk.ff == "moe":
            mo = self.moe
            mult = 3 if mo.gated else 2
            experts = mo.top_k if active else mo.num_experts
            n += D + D * mo.num_experts  # norm + router (always all)
            n += experts * mult * D * mo.d_ff
        return n


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set for LM-family archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    mode: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """Shapes that apply to this architecture (long_500k needs sub-quadratic)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return tuple(out)


# ---------------------------------------------------------------------------
# Mesh / run configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    microbatch: int = 0  # examples per microbatch; 0 = no accumulation
    # gradient compression: "none" | "int8_ef" (int8 + error feedback)
    grad_compression: str = "none"
    zero1: bool = True  # shard optimizer state
    moment_dtype: str = "float32"  # bf16 halves optimizer memory (405B-class)
    accum_dtype: str = "float32"  # gradient-accumulator dtype


@dataclasses.dataclass(frozen=True)
class PowerControlConfig:
    """Paper technique knobs (Cerf et al. 2021)."""

    enabled: bool = True
    epsilon: float = 0.10  # tolerable degradation
    tau_obj: float = 10.0  # desired closed-loop time constant [s]
    sampling_period: float = 1.0  # control period [s]
    pcap_min: float = 40.0
    pcap_max: float = 120.0
    plant_profile: str = "gros"  # identification profile / cluster name
    adaptive: bool = False  # RLS online re-identification (beyond paper)


def reduced(cfg: ModelConfig, vocab: int = 256) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    attn = dataclasses.replace(
        cfg.attn,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.attn.num_kv_heads, 2)),
        head_dim=16,
        sliding_window=32 if cfg.attn.sliding_window else None,
    )
    moe = (
        dataclasses.replace(cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
                            d_ff=32, group_size=16)
        if cfg.moe
        else None
    )
    mamba = (
        dataclasses.replace(cfg.mamba, d_state=4, chunk=8) if cfg.mamba else None
    )
    xlstm = (
        dataclasses.replace(cfg.xlstm, num_heads=2, chunk=8) if cfg.xlstm else None
    )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=len(cfg.pattern),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=vocab,
        attn=attn,
        moe=moe,
        mamba=mamba,
        xlstm=xlstm,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        sharding_recipe="dp",
    )
