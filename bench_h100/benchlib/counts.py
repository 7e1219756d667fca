"""Operations and bytes of the work the benchmark asks for, from shapes
alone: the nominal FLOPs of the BLAS-3 routines, each kernel's least
time on the roofline, and a decoder LM's model FLOPs a token.

Bytes count each input read once and each output written once, at the
element size given (4: fp32).  Nothing here reads the program."""

from __future__ import annotations

from benchlib import peaks


def gemm_flops(m: int, k: int, n: int) -> float:
    """C = A (m, k) @ B (k, n): 2mkn."""
    return 2.0 * m * k * n


def syrk_flops(m: int, k: int) -> float:
    """The triangle of A (m, k) @ A^T: m(m+1)k."""
    return float(m) * (m + 1) * k


def trsm_flops(m: int, n: int) -> float:
    """A X = B, A (m, m) triangular, B (m, n): m^2 n."""
    return float(m) * m * n


def routine_flops(routine: str, m: int, k: int, n: int) -> float:
    """Nominal FLOPs of one BLAS-3 call on the sample (m, k, n): gemm
    (m, k) x (k, n), syrk (m, k), trsm (m, m) against (m, n)."""
    if routine == "gemm":
        return gemm_flops(m, k, n)
    if routine == "syrk":
        return syrk_flops(m, k)
    if routine == "trsm":
        return trsm_flops(m, n)
    raise ValueError(f"unknown routine {routine!r}")


def gemm_bytes(m: int, k: int, n: int, itemsize: int = 4) -> float:
    return float(itemsize) * (m * k + k * n + m * n)


def grouped_flops(e: int, c: int, d: int, f: int) -> float:
    """E products (c, d) @ (d, f): 2ecdf."""
    return 2.0 * e * c * d * f


def grouped_bytes(e: int, c: int, d: int, f: int, itemsize: int = 4) -> float:
    return float(itemsize) * e * (c * d + d * f + c * f)


def least_s(flops: float, nbytes: float, peak_flops: float = peaks.FP32_FLOPS,
            bandwidth: float = peaks.HBM_BYTES) -> float:
    """The least time the card could take: the larger of operations at
    the peak rate and bytes at the peak bandwidth."""
    return max(flops / peak_flops, nbytes / bandwidth)


def gemm_least_s(m: int, k: int, n: int) -> float:
    return least_s(gemm_flops(m, k, n), gemm_bytes(m, k, n))


def grouped_least_s(e: int, c: int, d: int, f: int) -> float:
    return least_s(grouped_flops(e, c, d, f), grouped_bytes(e, c, d, f))


def lm_token_flops(cfg: dict, context: int) -> float:
    """Model FLOPs of one token of a decoder LM with grouped-query
    attention and a top-k MoE (every layer alike) that attends to
    ``context`` positions (itself included), without the output head:
    the q/k/v/o projections, QK^T and PV over the context, the router,
    and top_k expert MLPs (SwiGLU: three products).  Tokens a capacity
    limit drops still count at top_k; padding rows count as none.

    ``cfg`` holds the published keys (``hidden_size``,
    ``num_attention_heads``, ``num_key_value_heads``, ``head_dim`` or
    hidden / heads, ``intermediate_size``, ``num_local_experts``,
    ``num_experts_per_tok``, ``num_hidden_layers``)."""
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    hk = cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or d // h
    ff = cfg["intermediate_size"]
    e = cfg["num_local_experts"]
    top = cfg["num_experts_per_tok"]
    proj = 2.0 * d * (h * dh + 2 * hk * dh) + 2.0 * h * dh * d
    attn = 4.0 * h * dh * context
    router = 2.0 * d * e
    experts = top * 3 * 2.0 * d * ff
    return cfg["num_hidden_layers"] * (proj + attn + router + experts)


def lm_head_flops(cfg: dict) -> float:
    """The output head of one position: 2 d V."""
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def lm_prefill_flops(cfg: dict, n: int) -> float:
    """A prompt of n tokens processed at once (position i attends to
    i + 1 positions) and the head at its last position."""
    base = lm_token_flops(cfg, 0)
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    dh = cfg.get("head_dim") or d // h
    pairs = n * (n + 1) / 2.0
    return n * base + cfg["num_hidden_layers"] * 4.0 * h * dh * pairs \
        + lm_head_flops(cfg)


def lm_decode_flops(cfg: dict, context: int) -> float:
    """One decoded token attending to ``context`` positions, with its
    head."""
    return lm_token_flops(cfg, context) + lm_head_flops(cfg)
