"""flowNet: the adaLN flow-matching head and LSD Euler decode (counterpart of
``go_pocket_tts_tpu/models/flow_net.py``).

- two timestep embedders (times s and t): ``[cos(t·freqs), sin(t·freqs)]``
  → Linear → SiLU → Linear → RMSNorm(alpha, Bessel variance)
- conditioning ``y = 0.5·(emb_s + emb_t) + cond_embed(c)``
- N residual blocks: adaLN(SiLU(y)) → shift/scale/gate; LN(eps=1e-6) →
  modulate → Linear → SiLU → Linear → ·gate → +residual
- final layer: adaLN shift/scale → LN(no affine, eps=1e-6) → modulate →
  Linear
- LSD decode: Euler integration ``x += f(c, i/n, (i+1)/n, x) / n``

The runtime hoists :func:`precompute_time_cond` and
:func:`precompute_fused_adaln` out of the AR loop, as the reference does;
the adaLN projections of all blocks always run as one matmul.
:func:`flow_direction` is the flow field at one ``(s, t)`` pair for
callers outside that loop; it runs the same chain.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from go_pocket_tts_tpu_torch.models.params import (
    VarBuilder,
    apply_linear,
    layer_norm_params,
    linear_params,
)
from go_pocket_tts_tpu_torch.models.quantize import dequantize_weight, is_quantized
from go_pocket_tts_tpu_torch.ops import layer_norm, modulate, rms_norm_bessel, silu

__all__ = [
    "flow_direction",
    "load_flow_net",
    "precompute_time_cond",
    "precompute_fused_adaln",
    "lsd_decode",
]

Params = Dict


def _load_timestep_embedder(vb: VarBuilder) -> Params:
    return {
        "freqs": vb.tensor("freqs"),
        "mlp0": linear_params(vb, "mlp.0", with_bias=True),
        "mlp2": linear_params(vb, "mlp.2", with_bias=True),
        "alpha": vb.tensor("mlp.3.alpha"),
    }


def load_flow_net(vb: VarBuilder) -> Params:
    """Load flowNet params from ``flow_lm.flow_net`` (res-block count probed
    by key presence)."""
    res_blocks = []
    i = 0
    while vb.path("res_blocks", str(i)).has("in_ln.weight"):
        rb = vb.path("res_blocks", str(i))
        res_blocks.append(
            {
                "in_ln": layer_norm_params(rb, "in_ln"),
                "mlp0": linear_params(rb, "mlp.0", with_bias=True),
                "mlp2": linear_params(rb, "mlp.2", with_bias=True),
                "adaln": linear_params(rb, "adaLN_modulation.1", with_bias=True),
            }
        )
        i += 1
    if not res_blocks:
        raise ValueError("flow_net: no res blocks found")
    return {
        "time_embed_0": _load_timestep_embedder(vb.path("time_embed", "0")),
        "time_embed_1": _load_timestep_embedder(vb.path("time_embed", "1")),
        "cond_embed": linear_params(vb, "cond_embed", with_bias=True),
        "input_proj": linear_params(vb, "input_proj", with_bias=True),
        "res_blocks": res_blocks,
        "final_linear": linear_params(vb.path("final_layer"), "linear", with_bias=True),
        "final_adaln": linear_params(vb.path("final_layer"), "adaLN_modulation.1", with_bias=True),
    }


def _timestep_embed(params: Params, t: torch.Tensor) -> torch.Tensor:
    """``t``: [B, 1] float32 → [B, flow_dim] (float32: a float32 time
    promotes the products, as in the reference)."""
    args = t * params["freqs"][None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    x = silu(apply_linear(params["mlp0"], emb))
    x = apply_linear(params["mlp2"], x)
    return rms_norm_bessel(x, params["alpha"], eps=1e-5)


def _adaln_chunks(ada: torch.Tensor, fd: int, base: int, n: int):
    return [ada[:, base + j * fd : base + (j + 1) * fd] for j in range(n)]


def _flow_core(params: Params, fused_ada: Params, y: torch.Tensor, x: torch.Tensor):
    """Res-block chain + final layer with the batched adaLN projection."""
    n_blocks = len(params["res_blocks"])
    fd = params["input_proj"]["w"].shape[1]
    ada_all = apply_linear(fused_ada, silu(y))  # [B, (3n+2)·fd]

    cur = apply_linear(params["input_proj"], x)
    for i, rb in enumerate(params["res_blocks"]):
        shift, scale, gate = _adaln_chunks(ada_all, fd, i * 3 * fd, 3)
        h = layer_norm(cur, rb["in_ln"]["weight"], rb["in_ln"]["bias"], eps=1e-6)
        h = apply_linear(rb["mlp0"], modulate(h, shift, scale))
        h = apply_linear(rb["mlp2"], silu(h))
        cur = cur + h * gate
    shift, scale = _adaln_chunks(ada_all, fd, n_blocks * 3 * fd, 2)
    out = modulate(layer_norm(cur, eps=1e-6), shift, scale)
    return apply_linear(params["final_linear"], out)


def flow_direction(
    params: Params, c: torch.Tensor, s: torch.Tensor, t: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Flow field for latent ``x`` [B, L] under condition ``c`` [B, D] at
    integration times ``s``/``t`` [B, 1] (float32). It builds the fused
    adaLN weight on each call; :func:`lsd_decode` builds it once."""
    t0 = _timestep_embed(params["time_embed_0"], s)
    t1 = _timestep_embed(params["time_embed_1"], t)
    y = 0.5 * (t0 + t1) + apply_linear(params["cond_embed"], c)
    return _flow_core(params, precompute_fused_adaln(params), y, x)


def precompute_fused_adaln(params: Params) -> Params:
    """Concatenate every res-block's adaLN projection plus the final
    layer's into one ``[flow_dim, (3·n_blocks+2)·flow_dim]`` weight: all of
    them read the same ``silu(y)``, so each step makes one matmul of them.

    Sources of one quantized form (same weight dtype and scale rank)
    concatenate quantized, weights along the output dim and scales along
    their last axis (``[N]`` int8, ``[G, N]`` group-wise int4); otherwise
    the quantized ones are dequantized and the concat is float."""
    sources = [rb["adaln"] for rb in params["res_blocks"]] + [params["final_adaln"]]
    quantized = all(is_quantized(src) for src in sources) and (
        len({(src["w"].dtype, src["scale"].ndim) for src in sources}) == 1
    )
    ws = [
        dequantize_weight(src) if is_quantized(src) and not quantized else src["w"]
        for src in sources
    ]
    w = torch.cat(ws, dim=1)
    b = torch.cat(
        [
            src["b"] if "b" in src else torch.zeros(src["w"].shape[1], device=w.device)
            for src in sources
        ]
    )
    fused = {"w": w, "b": b}
    if quantized:
        fused["scale"] = torch.cat([src["scale"] for src in sources], dim=-1)
    return fused


def precompute_time_cond(params: Params, steps: int) -> torch.Tensor:
    """``[steps, flow_dim]`` float32 timestep-embedder outputs for the fixed
    Euler grid ``s=i/n, t=(i+1)/n`` (loop-invariant across the AR loop)."""
    device = params["input_proj"]["w"].device
    rows = []
    for i in range(steps):
        s = torch.full((1, 1), i / steps, dtype=torch.float32, device=device)
        t = torch.full((1, 1), (i + 1) / steps, dtype=torch.float32, device=device)
        t0 = _timestep_embed(params["time_embed_0"], s)
        t1 = _timestep_embed(params["time_embed_1"], t)
        rows.append((0.5 * (t0 + t1))[0])
    return torch.stack(rows)


def lsd_decode(
    params: Params,
    cond: torch.Tensor,
    x0: torch.Tensor,
    steps: int,
    time_cond: Optional[torch.Tensor] = None,
    fused_ada: Optional[Params] = None,
) -> torch.Tensor:
    """Euler-integrate the flow from noise ``x0`` [B, L] in ``steps`` steps.
    ``time_cond`` (from :func:`precompute_time_cond`) and ``fused_ada``
    (from :func:`precompute_fused_adaln`) are the loop invariants; callers
    that decode many frames build them once and pass them in, otherwise they
    are built here."""
    if steps <= 0:
        raise ValueError("lsd decode steps must be > 0")
    if time_cond is None:
        time_cond = precompute_time_cond(params, steps)
    if fused_ada is None:
        fused_ada = precompute_fused_adaln(params)
    cond_y = apply_linear(params["cond_embed"], cond)
    x = x0
    for i in range(steps):
        y = time_cond[i].to(cond_y.dtype) + cond_y
        x = x + _flow_core(params, fused_ada, y, x) * (1.0 / steps)
    return x
