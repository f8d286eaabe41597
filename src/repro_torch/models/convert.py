"""Conversion from the reference's trees to the port's modules and state.

The reference keeps parameters as nested dicts and lists of arrays; the
port keeps them in ``nn.Module`` state dicts. The converters take the
reference's tree with numpy leaves, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.resnet import ResNetConfig
from repro_torch.models.transformer import LMConfig, segment_sizes


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def resnet_params_from_jax(values_np: Dict[str, Any],
                           cfg: ResNetConfig) -> Dict[str, torch.Tensor]:
    """The reference ResNet's value tree (numpy leaves) -> the state dict of
    :class:`repro_torch.models.resnet.EarlyExitResNet`.

    Conv weights go from HWIO to OIHW; GroupNorm ``scale``/``bias`` become
    ``weight``/``bias``; the ``exit_head{s}`` matrices ``[C, classes]`` keep
    their layout.
    """
    sd: Dict[str, torch.Tensor] = {}

    def conv(key: str, hwio) -> None:
        sd[f"{key}.weight"] = _tensor(np.transpose(np.asarray(hwio),
                                                   (3, 2, 0, 1)))

    def norm(key: str, p) -> None:
        sd[f"{key}.weight"] = _tensor(p["scale"])
        sd[f"{key}.bias"] = _tensor(p["bias"])

    conv("stem", values_np["stem"])
    norm("stem_norm", values_np["stem_norm"])
    for s, n_blocks in enumerate(cfg.blocks):
        stage = values_np[f"layer{s + 1}"]
        if len(stage) != n_blocks:
            raise ValueError(f"layer{s + 1} has {len(stage)} blocks, the "
                             f"config {n_blocks}")
        for b, blk in enumerate(stage):
            prefix = f"layer{s + 1}.{b}"
            for name in ("conv1", "conv2", "conv3", "proj"):
                if name in blk:
                    conv(f"{prefix}.{name}", blk[name])
            for name in ("n1", "n2", "n3", "nproj"):
                if name in blk:
                    norm(f"{prefix}.{name}", blk[name])
    for s in range(4):
        sd[f"exit_head{s}"] = _tensor(values_np[f"exit_head{s}"])
    return sd


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _unstack(sd: Dict[str, torch.Tensor], prefix: str, tree, n: int,
             what: str) -> None:
    """Each stacked leaf ``path [n, ...]`` of ``tree`` becomes
    ``{prefix}.{l}.{path}`` for l < n."""
    for path, stacked in _flatten(tree):
        stacked = np.asarray(stacked)
        if stacked.shape[0] != n:
            raise ValueError(f"{what} {path} stacks {stacked.shape[0]} "
                             f"layers, the config {n}")
        for layer in range(n):
            sd[f"{prefix}.{layer}.{path}"] = _tensor(stacked[layer])


def lm_params_from_jax(values_np: Dict[str, Any],
                       cfg: LMConfig) -> Dict[str, torch.Tensor]:
    """The reference LM's value tree (numpy leaves; each segment's leaves
    stacked on a leading layers axis) -> the state dict of the port's model
    of the same family (``repro_torch.models.build_model(cfg)``).

    Segment ``i``'s stacked leaf ``path [n, ...]`` becomes
    ``segments.{i}.{l}.{path}`` for each of its n blocks, whatever the
    family's tree below: ``attn.wq``; the MoE's stacked experts
    ``ffn.we_gate`` and ``ffn.shared.w_up``; MLA's ``attn.wq_a ... wo``;
    Jamba's superblock sublayers ``sub{j}.mixer.a_log``; RWKV's
    ``tm.maa``/``cm.w_k``; the encoder-decoder's ``xattn.wq``, with its
    ``encoder`` stack as ``encoder.{l}.{path}`` and ``enc_norm``.
    ``exit_norms`` is a list in both; ``lm_head`` exists only when the
    embeddings are untied. Matrices keep their ``[in, out]`` layout. Leaves
    come back float32; ``load_state_dict`` casts them to the model's
    dtype.
    """
    sd: Dict[str, torch.Tensor] = {"embed": _tensor(values_np["embed"])}
    for e, gain in enumerate(values_np["exit_norms"]):
        sd[f"exit_norms.{e}"] = _tensor(gain)
    if not cfg.tie_embeddings:
        sd["lm_head"] = _tensor(values_np["lm_head"])
    if cfg.family == "encdec":
        sd["enc_norm"] = _tensor(values_np["enc_norm"])
        _unstack(sd, "encoder", values_np["encoder"], cfg.num_encoder_layers,
                 "encoder")
    sizes = segment_sizes(cfg)
    if len(values_np["segments"]) != len(sizes):
        raise ValueError(f"{len(values_np['segments'])} segments, the config "
                         f"{len(sizes)}")
    for i, (n, seg) in enumerate(zip(sizes, values_np["segments"])):
        _unstack(sd, f"segments.{i}", seg, n, f"segment {i}")
    return sd


def _state_tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype on ``device``; bfloat16
    leaves (numpy's ml_dtypes type) go through their 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.uint16)).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


# the leaf sets of one layer's cache: dense attention, MLA, the
# encoder-decoder's cross-attention K/V, a Mamba state, RWKV's time mix
# and channel mix
_LAYER_CACHES = ({"k", "v", "len"}, {"c_kv", "k_pe", "len"}, {"k", "v"},
                 {"h", "conv"}, {"shift", "wkv"}, {"shift"})


def _cache_tree(tree, device: torch.device):
    if not any(isinstance(v, dict) for v in tree.values()):
        if set(tree) not in _LAYER_CACHES:
            raise ValueError(
                f"a layer cache holds k, v and len (or c_kv, k_pe and len; "
                f"k and v; h and conv; shift and wkv; shift), not "
                f"{sorted(tree)}")
        out = {key: _state_tensor(value, device)
               for key, value in tree.items()}
        if "len" in out:
            out["len"] = out["len"].to(torch.int32)
        return out
    return {key: _cache_tree(value, device) for key, value in tree.items()}


def lm_cache_from_jax(cache_np: Dict[str, Any],
                      device: DeviceLike) -> Dict[str, Any]:
    """The reference LM's decode cache (numpy leaves) -> the port's, for
    every family: ``{"segments": [per segment, the same nested dict]}``
    with the leaves' dtypes (``len`` int32), on ``device`` (the card unless
    the caller passes ``"cpu"``). A segment holds the dense ``k``/``v``/
    ``len``, MLA's ``c_kv``/``k_pe``/``len``, Jamba's ``sub{j}`` (attention
    k/v/len or Mamba ``h``/``conv``), RWKV's ``tm`` {``shift``, ``wkv``}
    and ``cm`` {``shift``}, or the encoder-decoder's ``self`` and
    ``enc_kv``. The state counterpart of :func:`lm_params_from_jax`: both
    models can start from one cache, rows of different lengths
    included."""
    device = resolve_device(device)
    return {"segments": [_cache_tree(seg, device)
                         for seg in cache_np["segments"]]}
