"""The torch oracle backend (counterpart of the reference package's
``tts/runtime_torch.py``; ``--backend torch``).

The reference ships a second engine (ONNX Runtime via purego FFI,
`internal/onnx/`) next to its native Go engine, selected by
``--backend native-onnx`` and exercised by a cross-backend parity harness
(`internal/tts/parity.go`). This module fills the same slot with a
**torch implementation built independently from the checkpoint**: it reads
the weights through the :class:`Store` and shares no compute code with
``models/``, ``ops/``, ``kernels/`` or ``runtime/``, and it launches no
hand-written kernel, so it is a true cross-implementation oracle for the
CUDA engine's waveforms. It is selected by name only: nothing falls back to
it.

Implements the same ``Runtime`` contract as :class:`runtime.GPURuntime`:
``generate_audio(tokens, GenerateConfig) -> np.ndarray`` and
``mimi_timing()``. The AR loop here is host-driven (per-frame torch calls
and one host read of the EOS logit per frame): fine for an oracle, not a
serving path.

``device`` (default ``"cuda"``; raises without CUDA, ``"cpu"`` on request)
holds the weights, the KV lists and the computation; results leave through
``.cpu()``. On the card the computation is true float32
(:func:`device.exact_float32`), whatever the caller's TF32 flags. The noise
comes from a CPU ``torch.Generator`` seeded with ``seed`` and is moved to
the device, so one seed draws the same noise on every device.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, exact_float32, resolve_device
from go_pocket_tts_tpu_torch.model_assets.quantize_export import dequantize_weight_np
from go_pocket_tts_tpu_torch.runtime.generate import GenerateConfig
from go_pocket_tts_tpu_torch.text import estimate_max_frames
from go_pocket_tts_tpu_torch.utils.safetensors import Store, open_store

__all__ = ["TorchContinuation", "TorchRuntime"]


def _t(store: Store, name: str, device: torch.device) -> torch.Tensor:
    if store.dtype(name) in ("I8", "U8") and store.has(name + "_scale"):
        # Pre-quantized artifact (`model export --quantize`): reconstruct the
        # float weight — raw int codes cast to float would be silent garbage.
        w = dequantize_weight_np(store.tensor(name), store.tensor(name + "_scale"))
    else:
        w = store.tensor_f32(name)
    return torch.from_numpy(np.ascontiguousarray(w)).to(device)


class _Layers:
    """Flat name→tensor dict with helpers."""

    def __init__(self, store: Store, device: torch.device) -> None:
        self.store = store
        self.device = device
        self._cache: Dict[str, torch.Tensor] = {}

    def __call__(self, name: str) -> torch.Tensor:
        if name not in self._cache:
            self._cache[name] = _t(self.store, name, self.device)
        return self._cache[name]

    def has(self, name: str) -> bool:
        return self.store.has(name)

    def linear(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        w = self(f"{prefix}.weight")
        b = self(f"{prefix}.bias") if self.has(f"{prefix}.bias") else None
        return F.linear(x, w, b)

    def layer_norm(self, prefix: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return F.layer_norm(
            x, (x.shape[-1],), self(f"{prefix}.weight"), self(f"{prefix}.bias"), eps
        )


def _rope(x: torch.Tensor, pos0: int, max_period: float = 10000.0) -> torch.Tensor:
    """Interleaved-pair RoPE at absolute positions pos0..pos0+T-1."""
    *_, t, d = x.shape
    half = d // 2
    inv = max_period ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    angles = (torch.arange(pos0, pos0 + t, dtype=torch.float64, device=x.device)[:, None] * inv).to(x.dtype)
    cos, sin = torch.cos(angles), torch.sin(angles)
    xr = x.reshape(*x.shape[:-1], half, 2)
    a, b = xr[..., 0], xr[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).reshape(x.shape)


class TorchRuntime:
    def __init__(
        self,
        store: Store,
        num_heads: int = 16,
        seed: Optional[int] = None,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ) -> None:
        self.device = resolve_device(device)
        self.L = _Layers(store, self.device)
        self.num_heads = num_heads
        self.latent_dim = int(store.shape("flow_lm.bos_emb")[0])
        self.d_model = int(store.shape("flow_lm.input_linear.weight")[0])
        self.mimi_heads = 8
        self.mimi_context = 250
        self.frame_rate = 12.5
        self.encoder_frame_rate = 200.0
        self.sample_rate = 24_000
        self.rng = torch.Generator().manual_seed(
            seed if seed is not None else time.time_ns() & 0x7FFFFFFF
        )
        self.n_layers = 0
        while store.has(f"flow_lm.transformer.layers.{self.n_layers}.norm1.weight"):
            self.n_layers += 1
        self.n_mimi_layers = 0
        while store.has(
            f"mimi.decoder_transformer.transformer.layers.{self.n_mimi_layers}.norm1.weight"
        ):
            self.n_mimi_layers += 1

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "TorchRuntime":
        return cls(open_store(path), **kw)

    def _compute(self):
        """No autograd, and true float32 on the card."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        if self.device.type == "cuda":
            stack.enter_context(exact_float32())
        return stack

    def mimi_timing(self) -> Tuple[float, float, int]:
        return self.frame_rate, self.encoder_frame_rate, int(
            self.encoder_frame_rate / self.frame_rate
        )

    # -- FlowLM ------------------------------------------------------------

    def _attn_layer(
        self,
        prefix: str,
        x: torch.Tensor,
        kv: List[Optional[Tuple[torch.Tensor, torch.Tensor]]],
        idx: int,
        pos0: int,
        n_heads: int,
        context: Optional[int] = None,
    ) -> torch.Tensor:
        L = self.L
        b, t, d = x.shape
        hd = d // n_heads
        n1 = L.layer_norm(f"{prefix}.norm1", x)
        qkv = L.linear(f"{prefix}.self_attn.in_proj", n1)
        q, k, v = qkv.chunk(3, dim=-1)
        q = _rope(q.view(b, t, n_heads, hd).transpose(1, 2), pos0)
        k = _rope(k.view(b, t, n_heads, hd).transpose(1, 2), pos0)
        v = v.view(b, t, n_heads, hd).transpose(1, 2)
        if kv[idx] is not None:
            k = torch.cat([kv[idx][0], k], dim=2)
            v = torch.cat([kv[idx][1], v], dim=2)
        kv[idx] = (k, v)
        tk = k.shape[2]
        pos_q = torch.arange(pos0, pos0 + t, device=x.device)[:, None]
        pos_k = torch.arange(tk, device=x.device)[None, :]
        delta = pos_q - pos_k
        mask = delta >= 0
        if context is not None:
            mask &= delta < context
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask[None, None])
        a = a.transpose(1, 2).reshape(b, t, d)
        x = x + L.linear(f"{prefix}.self_attn.out_proj", a)
        n2 = L.layer_norm(f"{prefix}.norm2", x)
        ff = L.linear(f"{prefix}.linear1", n2)
        ff = F.gelu(ff, approximate="none")
        return x + L.linear(f"{prefix}.linear2", ff)

    def _flow_step(
        self,
        frame: torch.Tensor,
        kv: List[Optional[Tuple[torch.Tensor, torch.Tensor]]],
        pos0: int,
    ) -> torch.Tensor:
        L = self.L
        bos = L("flow_lm.bos_emb")
        seq = torch.where(torch.isnan(frame), bos.expand_as(frame), frame)
        x = L.linear("flow_lm.input_linear", seq)
        for i in range(self.n_layers):
            x = self._attn_layer(
                f"flow_lm.transformer.layers.{i}", x, kv, i, pos0, self.num_heads
            )
        x = L.layer_norm("flow_lm.out_norm", x)
        return x[:, -1]

    def _timestep_embed(self, prefix: str, t: torch.Tensor) -> torch.Tensor:
        L = self.L
        args = t * L(f"{prefix}.freqs")[None, :]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        h = F.silu(L.linear(f"{prefix}.mlp.0", emb))
        h = L.linear(f"{prefix}.mlp.2", h)
        var = h.var(dim=-1, keepdim=True)  # Bessel, upstream _rms_norm quirk
        return h / torch.sqrt(var + 1e-5) * L(f"{prefix}.mlp.3.alpha")

    def _flow_direction(self, c, s, t, x) -> torch.Tensor:
        L = self.L
        xp = L.linear("flow_lm.flow_net.input_proj", x)
        y = 0.5 * (
            self._timestep_embed("flow_lm.flow_net.time_embed.0", s)
            + self._timestep_embed("flow_lm.flow_net.time_embed.1", t)
        ) + L.linear("flow_lm.flow_net.cond_embed", c)
        cur = xp
        i = 0
        while L.has(f"flow_lm.flow_net.res_blocks.{i}.in_ln.weight"):
            p = f"flow_lm.flow_net.res_blocks.{i}"
            ada = L.linear(f"{p}.adaLN_modulation.1", F.silu(y))
            shift, scale, gate = ada.chunk(3, dim=-1)
            h = L.layer_norm(f"{p}.in_ln", cur, eps=1e-6)
            h = h * (1 + scale) + shift
            h = L.linear(f"{p}.mlp.2", F.silu(L.linear(f"{p}.mlp.0", h)))
            cur = cur + h * gate
            i += 1
        ada = L.linear("flow_lm.flow_net.final_layer.adaLN_modulation.1", F.silu(y))
        shift, scale = ada.chunk(2, dim=-1)
        out = F.layer_norm(cur, (cur.shape[-1],), eps=1e-6)
        out = out * (1 + scale) + shift
        return L.linear("flow_lm.flow_net.final_layer.linear", out)

    def _lsd_decode(self, cond, x0, steps: int) -> torch.Tensor:
        x = x0.clone()
        for i in range(steps):
            s = torch.full((x.shape[0], 1), i / steps, device=x.device)
            t = torch.full((x.shape[0], 1), (i + 1) / steps, device=x.device)
            x = x + self._flow_direction(cond, s, t, x) / steps
        return x

    # -- Mimi --------------------------------------------------------------

    def _causal_conv(self, prefix: str, x, stride=1, dilation=1, groups=1):
        L = self.L
        w = L(f"{prefix}.weight")
        b = L(f"{prefix}.bias") if L.has(f"{prefix}.bias") else None
        k = w.shape[-1]
        eff = (k - 1) * dilation + 1
        x = F.pad(x, (max(eff - stride, 0), 0))
        return F.conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)

    def _convtr_trim(self, prefix: str, x, stride, groups=1):
        L = self.L
        w = L(f"{prefix}.weight")
        b = L(f"{prefix}.bias") if L.has(f"{prefix}.bias") else None
        out = F.conv_transpose1d(x, w, b, stride=stride, groups=groups)
        trim = w.shape[-1] - stride
        return out[:, :, : out.shape[2] - trim] if trim > 0 else out

    def _mimi_transformer(self, x: torch.Tensor) -> torch.Tensor:
        L = self.L
        x = x.transpose(1, 2)  # [B,T,C]
        kv: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [None] * self.n_mimi_layers
        for i in range(self.n_mimi_layers):
            p = f"mimi.decoder_transformer.transformer.layers.{i}"
            b, t, d = x.shape
            hd = d // self.mimi_heads
            n1 = L.layer_norm(f"{p}.norm1", x)
            qkv = L.linear(f"{p}.self_attn.in_proj", n1)
            q, k, v = qkv.chunk(3, dim=-1)
            q = _rope(q.view(b, t, self.mimi_heads, hd).transpose(1, 2), 0)
            k = _rope(k.view(b, t, self.mimi_heads, hd).transpose(1, 2), 0)
            v = v.view(b, t, self.mimi_heads, hd).transpose(1, 2)
            pos = torch.arange(t, device=x.device)
            delta = pos[:, None] - pos[None, :]
            mask = (delta >= 0) & (delta < self.mimi_context)
            a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask[None, None])
            a = a.transpose(1, 2).reshape(b, t, d)
            a = L.linear(f"{p}.self_attn.out_proj", a)
            if L.has(f"{p}.layer_scale_1.scale"):
                a = a * L(f"{p}.layer_scale_1.scale")
            x = x + a
            n2 = L.layer_norm(f"{p}.norm2", x)
            ff = F.gelu(L.linear(f"{p}.linear1", n2), approximate="none")
            ff = L.linear(f"{p}.linear2", ff)
            if L.has(f"{p}.layer_scale_2.scale"):
                ff = ff * L(f"{p}.layer_scale_2.scale")
            x = x + ff
        return x.transpose(1, 2)

    def _mimi_decode(self, latent: torch.Tensor) -> torch.Tensor:
        """[B, C, T] → [B, 1, N]."""
        L = self.L
        up_groups = int(L("mimi.upsample.convtr.convtr.weight").shape[0])
        steps = int(self.encoder_frame_rate / self.frame_rate)
        x = self._convtr_trim("mimi.upsample.convtr.convtr", latent, steps, up_groups)
        x = self._mimi_transformer(x)
        x = self._causal_conv("mimi.decoder.model.0.conv", x)
        x = F.elu(x)
        for up_idx, res_idx, stride in ((2, 3, 6), (5, 6, 5), (8, 9, 4)):
            x = self._convtr_trim(f"mimi.decoder.model.{up_idx}.convtr", x, stride)
            h = F.elu(x)
            h = self._causal_conv(f"mimi.decoder.model.{res_idx}.block.1.conv", h)
            h = F.elu(h)
            h = self._causal_conv(f"mimi.decoder.model.{res_idx}.block.3.conv", h)
            x = x + h
            x = F.elu(x)
        return self._causal_conv("mimi.decoder.model.11.conv", x)

    # -- Mimi encoder (voice cloning oracle) --------------------------------

    def encode_voice(self, samples: np.ndarray) -> np.ndarray:
        """Speaker audio → conditioning [1, T, d_model]; independent torch
        implementation of the native JAX path (`models/mimi_encoder.py` +
        speaker projection), used for cross-implementation parity."""
        L = self.L
        with self._compute():
            x = torch.from_numpy(np.asarray(samples, np.float32))[None, None, :].to(self.device)
            x = self._causal_conv("mimi.encoder.model.0.conv", x)
            for res_idx, down_idx, stride in ((1, 3, 4), (4, 6, 5), (7, 9, 6)):
                h = F.elu(x)
                h = self._causal_conv(f"mimi.encoder.model.{res_idx}.block.1.conv", h)
                h = F.elu(h)
                h = self._causal_conv(f"mimi.encoder.model.{res_idx}.block.3.conv", h)
                x = x + h
                x = F.elu(x)
                x = self._causal_conv(f"mimi.encoder.model.{down_idx}.conv", x, stride=stride)
            x = F.elu(x)
            x = self._causal_conv("mimi.encoder.model.11.conv", x)
            # encoder transformer (same layer math as the decoder's)
            n_enc = 0
            while L.has(f"mimi.encoder_transformer.transformer.layers.{n_enc}.norm1.weight"):
                n_enc += 1
            x = x.transpose(1, 2)
            for i in range(n_enc):
                p = f"mimi.encoder_transformer.transformer.layers.{i}"
                b, t, d = x.shape
                hd = d // self.mimi_heads
                n1 = L.layer_norm(f"{p}.norm1", x)
                qkv = L.linear(f"{p}.self_attn.in_proj", n1)
                q, k, v = qkv.chunk(3, dim=-1)
                q = _rope(q.view(b, t, self.mimi_heads, hd).transpose(1, 2), 0)
                k = _rope(k.view(b, t, self.mimi_heads, hd).transpose(1, 2), 0)
                v = v.view(b, t, self.mimi_heads, hd).transpose(1, 2)
                pos = torch.arange(t, device=x.device)
                delta = pos[:, None] - pos[None, :]
                mask = (delta >= 0) & (delta < self.mimi_context)
                a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask[None, None])
                a = a.transpose(1, 2).reshape(b, t, d)
                a = L.linear(f"{p}.self_attn.out_proj", a)
                if L.has(f"{p}.layer_scale_1.scale"):
                    a = a * L(f"{p}.layer_scale_1.scale")
                x = x + a
                n2 = L.layer_norm(f"{p}.norm2", x)
                ff = F.gelu(L.linear(f"{p}.linear1", n2), approximate="none")
                ff = L.linear(f"{p}.linear2", ff)
                if L.has(f"{p}.layer_scale_2.scale"):
                    ff = ff * L(f"{p}.layer_scale_2.scale")
                x = x + ff
            x = x.transpose(1, 2)
            w = L("mimi.downsample.conv.conv.weight")
            groups = w.shape[0] if w.shape[1] == 1 else 1
            steps = int(self.encoder_frame_rate / self.frame_rate)
            x = self._causal_conv("mimi.downsample.conv.conv", x, stride=steps, groups=groups)
            proj = L("condition_provider.conditioners.speaker_wavs.output_proj.weight")
            out = torch.einsum("bct,dc->btd", x, proj)
        return out.cpu().numpy().astype(np.float32)

    # -- generation --------------------------------------------------------

    def generate_audio(self, tokens, cfg: GenerateConfig) -> np.ndarray:
        audio, _kv, _pos = self._generate_core(tokens, cfg, None, 0)
        return audio

    def generate_audio_session(
        self, tokens, cfg: GenerateConfig, cont: Optional["TorchContinuation"] = None
    ):
        """Long-form continuity: carry the per-layer KV lists + position
        across chunks (independent cross-check of the JAX session semantics
        — hydrated positions continue, prosody conditions on the session
        history). The eager KV lists grow unbounded, so unlike the JAX
        engines there is no capacity reset."""
        kv0 = pos0 = None
        if cont is not None:
            kv0 = [None if p is None else (p[0], p[1]) for p in cont.kv]
            pos0 = cont.pos
            if cfg.voice_embedding is not None or cfg.voice_model_state is not None:
                # Carried state supersedes voice (same contract as the JAX
                # session paths — the session cache carries chunk 1's voice).
                import dataclasses as _dc

                cfg = _dc.replace(cfg, voice_embedding=None, voice_model_state=None)
        audio, kv, pos = self._generate_core(
            tokens, cfg, kv0, pos0 if pos0 is not None else 0
        )
        return audio, TorchContinuation(kv=kv, pos=pos)

    def _generate_core(self, tokens, cfg: GenerateConfig, kv0, session_pos0: int):
        if len(tokens) == 0:
            raise ValueError("generate: token slice must not be empty")
        if cfg.voice_embedding is not None and cfg.voice_model_state is not None:
            raise ValueError(
                "generate: voice embedding and voice model state are mutually exclusive"
            )
        L = self.L
        max_steps = cfg.max_steps or cfg.estimated_max_steps or estimate_max_frames(len(tokens))
        decode_steps = max(cfg.lsd_decode_steps, 1)
        sigma = math.sqrt(max(cfg.temperature, 0.0))

        dev = self.device
        with self._compute():
            ids = torch.tensor(list(tokens), dtype=torch.long, device=dev)
            emb = L("flow_lm.conditioner.embed.weight")[ids][None]
            if cfg.voice_embedding is not None:
                voice = torch.from_numpy(np.asarray(cfg.voice_embedding, np.float32)).to(dev)
                emb = torch.cat([voice, emb], dim=1)

            kv: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = (
                list(kv0) if kv0 is not None else [None] * self.n_layers
            )
            pos0 = session_pos0
            if cfg.voice_model_state is not None:
                for i in range(self.n_layers):
                    mod = cfg.voice_model_state.modules[
                        f"transformer.layers.{i}.self_attn"
                    ]
                    cache = torch.from_numpy(np.asarray(mod["cache"], np.float32)).to(dev)
                    off = int(np.asarray(mod["offset"]).reshape(-1)[0])
                    k = cache[0, :, :off].permute(0, 2, 1, 3)  # [B,H,T,Dh]
                    v = cache[1, :, :off].permute(0, 2, 1, 3)
                    kv[i] = (k, v)
                pos0 = int(
                    np.asarray(
                        next(iter(cfg.voice_model_state.modules.values()))["offset"]
                    ).reshape(-1)[0]
                )

            # Prefill.
            x = emb
            for i in range(self.n_layers):
                x = self._attn_layer(
                    f"flow_lm.transformer.layers.{i}", x, kv, i, pos0, self.num_heads
                )
            pos = pos0 + emb.shape[1]

            frame = torch.full((1, 1, self.latent_dim), float("nan"), device=dev)
            frames = []
            countdown = None
            for _step in range(max_steps):
                hidden = self._flow_step(frame, kv, pos)
                pos += 1
                eos_logit = float(L.linear("flow_lm.out_eos", hidden)[0, 0])
                noise = torch.randn(1, self.latent_dim, generator=self.rng).to(dev) * sigma
                nxt = self._lsd_decode(hidden, noise, decode_steps)
                frame = nxt[:, None, :]
                frames.append(frame[0, 0])
                if eos_logit > cfg.eos_threshold and countdown is None:
                    countdown = cfg.frames_after_eos
                if countdown is not None:
                    if countdown == 0:
                        break
                    countdown -= 1

            latent = torch.stack(frames)[None]  # [1, T, L]
            # latent→mimi: denorm + 1×1 quantizer projection.
            denorm = latent * L("flow_lm.emb_std") + L("flow_lm.emb_mean")
            w = L("mimi.quantizer.output_proj.weight")[:, :, 0]
            mimi_latent = torch.einsum("oc,btc->bot", w, denorm)
            audio = self._mimi_decode(mimi_latent)

        if cfg.step_callback is not None:
            cfg.step_callback(len(frames), max_steps)
        return audio[0, 0].cpu().numpy().astype(np.float32), kv, pos

    def close(self) -> None:
        pass


@dataclass
class TorchContinuation:
    """Cross-chunk session state for the torch oracle: per-layer KV tensors
    ``[B, H, T, Dh]`` plus the next absolute position."""

    kv: List[Optional[Tuple[torch.Tensor, torch.Tensor]]]
    pos: int
