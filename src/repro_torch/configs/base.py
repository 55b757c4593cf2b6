"""Model / run configuration schema; a copy of ``repro/configs/base.py``.

One ModelConfig per assigned architecture lives in
``repro_torch/configs/<id>.py``; ``repro_torch.configs.registry`` resolves
``--arch <id>``.  Configs are frozen dataclasses, hashable.  The port keeps
its own copy (it imports nothing of ``repro``); the fields, defaults and
``param_count`` are the reference's, held equal by
``tests/test_torch_models.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["dense", "moe", "mamba", "hybrid", "enc", "dec"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention ---
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    sliding_window: int | None = None   # window size; None = full attention
    global_layer_every: int = 0         # hybrid: every k-th layer full attn
    attn_logit_softcap: float | None = None
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl M-RoPE (stub)

    # --- mlp ---
    act: str = "silu"                # silu (swiglu) | gelu
    tie_embeddings: bool = False

    # --- moe ---
    num_experts: int = 0
    experts_per_token: int = 2
    moe_d_ff: int = 0                # expert hidden dim (0 -> d_ff)
    dense_residual_d_ff: int = 0     # arctic: parallel dense FFN branch
    capacity_factor: float = 1.25

    # --- ssm (mamba1) ---
    ssm_state: int = 0
    d_inner: int = 0                 # 0 -> 2*d_model when mamba is used
    dt_rank: int = 0                 # 0 -> ceil(d_model/16)
    conv_width: int = 4

    # --- structure ---
    block_pattern: tuple[tuple[str, int], ...] = ()   # [(kind, count), ...]
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500      # whisper audio frames after conv stub
    frontend: str = "none"           # none | audio | vision  (stubs)
    norm_eps: float = 1e-5
    source: str = ""                 # provenance note [source; verified-tier]

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_state and not self.d_inner:
            object.__setattr__(self, "d_inner", 2 * self.d_model)
        if self.ssm_state and not self.dt_rank:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))
        if self.num_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if not self.block_pattern:
            kind = ("moe" if self.num_experts else
                    "mamba" if self.ssm_state and not self.num_heads else
                    "dense")
            object.__setattr__(self, "block_pattern",
                               ((kind, self.num_layers),))
        assert sum(c for _, c in self.block_pattern) == self.num_layers, (
            self.name, self.block_pattern, self.num_layers)

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is feasible (SSM/hybrid/SWA)."""
        if self.ssm_state and not self.num_heads:
            return True                          # pure SSM
        if self.sliding_window is not None:
            return True                          # SWA (maybe + few global)
        return False

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                                   # embedding
        if not self.tie_embeddings:
            total += v * d                              # lm head
        for kind, count in self.block_pattern:
            total += count * self._block_params(kind)
        total += d                                      # final norm
        if self.is_encoder_decoder:
            total += self.num_encoder_layers * self._block_params("enc")
        return total

    def _attn_params(self) -> int:
        d, h, kh, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        n = d * h * hd + 2 * d * kh * hd + h * hd * d
        if self.qkv_bias:
            n += h * hd + 2 * kh * hd
        return n

    def _mlp_params(self, ff: int) -> int:
        d = self.d_model
        if self.act == "silu":
            return 3 * d * ff        # swiglu: w1, w3, w2
        return 2 * d * ff

    def _mamba_params(self) -> int:
        d, di, n, dtr, cw = (self.d_model, self.d_inner, self.ssm_state,
                             self.dt_rank, self.conv_width)
        return (d * 2 * di            # in_proj (x, z)
                + di * cw             # depthwise conv
                + di * (dtr + 2 * n)  # x_proj -> (dt, B, C)
                + dtr * di + di       # dt_proj
                + di * n + di         # A_log, D
                + di * d)             # out_proj

    def _block_params(self, kind: str) -> int:
        kind = kind.replace("_global", "")
        d = self.d_model
        norms = 2 * d
        if kind == "dense":
            return self._attn_params() + self._mlp_params(self.d_ff) + norms
        if kind == "moe":
            n = self._attn_params() + norms + d * self.num_experts
            n += self.num_experts * self._mlp_params(self.moe_d_ff) // 1
            if self.dense_residual_d_ff:
                n += self._mlp_params(self.dense_residual_d_ff) + d
            return n
        if kind == "mamba":
            return self._mamba_params() + d  # one norm
        if kind == "hybrid":
            return (self._attn_params() + self._mamba_params()
                    + self._mlp_params(self.d_ff) + norms + d)
        if kind == "enc":
            return self._attn_params() + self._mlp_params(self.d_ff) + norms
        if kind == "dec":  # self-attn + cross-attn + mlp
            return (2 * self._attn_params() + self._mlp_params(self.d_ff)
                    + 3 * d)
        raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving hyper-parameters + parallelism knobs."""
    seq_len: int = 4096
    global_batch: int = 256
    microbatch: int = 0              # 0 = no microbatching
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    param_dtype: str = "bfloat16"
    remat: str = "block"             # none | block | full
    seq_parallel: bool = False       # shard activation seq dim over model axis
    loss_chunk: int = 512            # vocab-loss seq chunking
    q_block: int = 512               # blockwise attention tiles
    kv_block: int = 1024
    attn_dtype: str = "f32"          # score/PV matmul input dtype (bf16|f32)
    scan_chunk: int = 128            # mamba chunk length: where the bf16
                                     # a/b scan carries h in float32
    ssm_dtype: str = "f32"           # mamba a/b tensor dtype (bf16|f32)
    moe_impl: str = "einsum"         # einsum | sort
    moe_combine_dtype: str = "f32"   # GShard combine-weights dtype
    moe_group_size: int = 0          # tokens per dispatch group (0 = one
                                     # group per batch row — GShard default)
    coded_head: bool = False         # Lagrange-coded LM head (core/coded_linear)
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
