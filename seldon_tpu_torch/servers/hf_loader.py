"""HuggingFace Llama-family checkpoint loader -> the port's Transformer.

Port of ``seldon_tpu/servers/hf_loader.py`` (the port keeps its own copy
of ``config_from_hf``; tests/test_torch_hf_loader.py holds the two
against each other). Point ``modelUri`` at an HF Llama checkpoint
directory (config.json + *.safetensors) and serve it. The loader reads
safetensors SHARD BY SHARD with its own reader (:func:`read_safetensors`:
no ``safetensors`` or ``transformers`` package needed), transposes HF's
[out, in] projection layout into the JAX package's [in, out] layout,
keeps norms in f32 and STACKS the per-layer tensors on a leading
[L, ...] axis: :func:`hf_tree` returns the JAX loader's parameter tree
with numpy leaves (bf16 as its 16-bit pattern), and
:func:`load_hf_checkpoint` builds the port's :class:`Transformer` from it
on the serving device through ``models/convert.params_from_numpy``.
Under tensor parallelism :func:`load_hf_shard` builds one rank's shard
leaf by leaf, reading only that rank's rows of each column-sharded
projection, so no rank holds the whole model (the JAX loader's
``make_shardings`` route).

RoPE convention matches: HF Llama applies rotate_half over a half-split
pairing, exactly ``models/transformer.py``'s rope — checked by the
logit-parity test against ``transformers``' own forward.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from seldon_tpu_torch.device import DeviceLike, resolve_device
from seldon_tpu_torch.models.config import ModelConfig
from seldon_tpu_torch.models.convert import params_from_numpy
from seldon_tpu_torch.models.transformer import Transformer, check_supported

logger = logging.getLogger(__name__)


def _rope_scaling_fields(hf: Dict[str, Any]) -> Dict[str, Any]:
    """Map HF `rope_scaling` (Llama-3.1/3.2 long-context checkpoints)
    onto ModelConfig's flat rope_scaling_* fields. Unknown schemes raise
    rather than silently producing wrong logits at every position."""
    rs = hf.get("rope_scaling")
    if not rs:
        return {}
    # HF renamed "type" -> "rope_type" across versions; accept both.
    rtype = rs.get("rope_type", rs.get("type"))
    if rtype == "default":
        return {}
    if rtype == "linear":
        return {
            "rope_scaling_type": "linear",
            "rope_scaling_factor": float(rs["factor"]),
        }
    if rtype == "llama3":
        return {
            "rope_scaling_type": "llama3",
            "rope_scaling_factor": float(rs["factor"]),
            "rope_scaling_low_freq_factor": float(
                rs.get("low_freq_factor", 1.0)
            ),
            "rope_scaling_high_freq_factor": float(
                rs.get("high_freq_factor", 4.0)
            ),
            "rope_scaling_original_max_position": int(
                rs.get("original_max_position_embeddings", 8192)
            ),
        }
    raise ValueError(
        f"unsupported rope_scaling {rs!r}; this loader implements "
        "'linear' and 'llama3' frequency scaling"
    )


def config_from_hf(hf: Dict[str, Any]) -> ModelConfig:
    """ModelConfig from an HF llama config.json dict."""
    mt = hf.get("model_type", "llama")
    if mt not in ("llama", "mistral"):
        raise ValueError(
            f"unsupported model_type {mt!r}; this loader handles the "
            "Llama family (llama, mistral)"
        )
    return ModelConfig(
        **_rope_scaling_fields(hf),
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads",
                          hf["num_attention_heads"]),
        d_ff=hf["intermediate_size"],
        max_seq_len=hf.get("max_position_embeddings", 4096),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        eos_token_id=(
            hf.get("eos_token_id", 2)[0]
            if isinstance(hf.get("eos_token_id"), list)
            else hf.get("eos_token_id", 2)
        ),
        pad_token_id=hf.get("pad_token_id") or 0,
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
    )


# safetensors dtype tag -> the numpy dtype its bytes are read as (BF16
# as its 16-bit pattern: numpy has no bfloat16).
_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": np.uint16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
    "I8": np.int8, "U64": np.uint64, "U32": np.uint32, "U16": np.uint16,
    "U8": np.uint8, "BOOL": np.bool_,
}

# A header longer than this is refused before it is read, as the
# ``safetensors`` package refuses one (its cap is 100 MB).
_MAX_HEADER_BYTES = 100_000_000


def read_safetensors(path: str) -> Iterator[Tuple[str, str, np.ndarray]]:
    """Yield (tensor name, safetensors dtype tag, array) from one
    .safetensors file, in header order. The format: an 8-byte
    little-endian header length N, N bytes of JSON ({name: {"dtype",
    "shape", "data_offsets": [begin, end]}}, plus "__metadata__"), then
    the raw little-endian tensor bytes, offsets relative to their start.
    Arrays are read-only views of one ``numpy.memmap`` of the file; BF16
    arrives as ``uint16`` bit patterns."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        if n > min(size - 8, _MAX_HEADER_BYTES):
            raise ValueError(f"{path}: header length {n} does not fit a "
                             f"file of {size} bytes (at most "
                             f"{_MAX_HEADER_BYTES} header bytes)")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    if not header:
        return
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    for name, meta in header.items():
        tag = meta["dtype"]
        if tag not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype "
                             f"{tag!r}")
        begin, end = meta["data_offsets"]
        dt = np.dtype(_ST_DTYPES[tag]).newbyteorder("<")
        if (not 0 <= begin <= end <= data.size
                or end - begin != dt.itemsize * int(np.prod(meta["shape"]))):
            raise ValueError(f"{path}: tensor {name} has data_offsets "
                             f"{meta['data_offsets']} that do not fit its "
                             f"{tag} shape {meta['shape']} in the file")
        arr = data[begin:end].view(dt).reshape(meta["shape"])
        yield name, tag, arr


def _open_shards(path: str) -> Iterator[Tuple[str, str, np.ndarray]]:
    """Yield (tensor_name, dtype tag, array) from all safetensors
    shards: those named by model.safetensors.index.json when it exists,
    else every *.safetensors file in the directory."""
    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            weight_map = json.load(f)["weight_map"]
        shards = sorted(set(weight_map.values()))
    else:
        shards = [
            f for f in sorted(os.listdir(path)) if f.endswith(".safetensors")
        ]
        if not shards:
            raise FileNotFoundError(f"no *.safetensors under {path}")
    for shard in shards:
        yield from read_safetensors(os.path.join(path, shard))


def _convert(tag: str, arr: np.ndarray, transpose: bool,
             f32: bool) -> np.ndarray:
    """One checkpoint tensor as a numpy leaf of the JAX loader's tree:
    transposed ([out, in] -> [in, out]) when asked, f32 when ``f32`` (the
    norms, and every leaf of a float32 load), else bf16 as uint16 bit
    patterns (the cast rounds to nearest even, as ml_dtypes' does)."""
    a = np.array(arr)  # owned: the memmap view is read-only
    t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
         if tag == "BF16" else torch.from_numpy(a))
    if transpose:
        t = t.t()
    if f32:
        return t.to(torch.float32).contiguous().numpy()
    t = t.to(torch.bfloat16).contiguous()
    return t.view(torch.int16).numpy().view(np.uint16)


_LAYER_MAP = {  # HF name -> (slot, transpose?, is_norm)
    "input_layernorm.weight": ("attn_norm", False, True),
    "self_attn.q_proj.weight": ("wq", True, False),
    "self_attn.k_proj.weight": ("wk", True, False),
    "self_attn.v_proj.weight": ("wv", True, False),
    "self_attn.o_proj.weight": ("wo", True, False),
    "post_attention_layernorm.weight": ("mlp_norm", False, True),
    "mlp.gate_proj.weight": ("w_gate", True, False),
    "mlp.up_proj.weight": ("w_up", True, False),
    "mlp.down_proj.weight": ("w_down", True, False),
}


def checkpoint_config(path: str, dtype: str = "bfloat16") -> ModelConfig:
    """The validated ModelConfig of a local HF checkpoint directory, in
    compute dtype ``dtype`` (bfloat16 or float32)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    return check_supported(dataclasses.replace(cfg, dtype=dtype))


def _leaves(path: str, cfg: ModelConfig, cols=None
            ) -> Iterator[Tuple[tuple, str, np.ndarray]]:
    """Yield (leaf path, leaf name, numpy leaf) for every checkpoint
    tensor the port maps, in file order: path ``()`` for embed /
    final_norm / lm_head, ``(layer,)`` for a block leaf, the leaf in the
    JAX loader's layout (:func:`_convert`). ``cols(path, name)`` may name
    the ``(lo, hi)`` output columns of an ``[in, out]`` projection to
    keep: only HF's rows ``[lo, hi)`` of its ``[out, in]`` tensor are
    read from the memmapped file. Raises where :func:`hf_tree` does for
    a missing tensor, a missing ``embed_tokens`` or a missing
    ``lm_head``."""
    seen = set()
    n_seen = 0
    for name, tag, arr in _open_shards(path):
        n_seen += 1
        if name == "model.embed_tokens.weight":
            key, tr, norm = ((), "embed"), False, False
        elif name == "model.norm.weight":
            key, tr, norm = ((), "final_norm"), False, True
        elif name == "lm_head.weight":
            if cfg.tie_embeddings:
                logger.warning("tie_word_embeddings set; ignoring lm_head")
                continue
            key, tr, norm = ((), "lm_head"), True, False
        elif name.startswith("model.layers."):
            rest = name[len("model.layers."):]
            idx_s, _, sub = rest.partition(".")
            slot = _LAYER_MAP.get(sub)
            if slot is None:
                logger.warning("skipping unmapped tensor %s", name)
                continue
            key, tr, norm = ((int(idx_s),), slot[0]), slot[1], slot[2]
        else:
            logger.warning("skipping unmapped tensor %s", name)
            continue
        span = cols(*key) if cols is not None else None
        if span is not None:
            arr = arr[span[0]:span[1]]  # HF [out, in]: output rows
        seen.add(key)
        yield key[0], key[1], _convert(tag, arr, tr,
                                       norm or cfg.dtype == "float32")

    missing = [f"layer {i}.{k}" for k, _, _ in _LAYER_MAP.values()
               for i in range(cfg.n_layers) if ((i,), k) not in seen]
    if missing:
        raise ValueError(
            f"checkpoint incomplete ({n_seen} tensors read); missing: "
            + ", ".join(missing[:8])
        )
    if ((), "embed") not in seen:
        raise ValueError("checkpoint has no model.embed_tokens.weight")
    if not cfg.tie_embeddings and ((), "lm_head") not in seen:
        raise ValueError(
            "config has tie_word_embeddings=false but no lm_head.weight"
        )


def hf_tree(path: str, dtype: str = "bfloat16"
            ) -> Tuple[Dict[str, Any], ModelConfig]:
    """(tree, cfg) from a local HF Llama checkpoint directory: the JAX
    ``load_hf_checkpoint(path, dtype)``'s parameter tree with numpy leaves
    (blocks stacked [L, ...]; leaves in ``dtype``, norms f32), and the
    same errors for a missing tensor, a missing ``embed_tokens`` and a
    missing ``lm_head``. ``cfg.dtype`` is ``dtype`` (the JAX loader's cfg
    keeps the default and its callers replace it)."""
    cfg = checkpoint_config(path, dtype)
    # Per-layer slots filled as shards stream by; stacked at the end.
    per_layer: Dict[str, list] = {
        slot: [None] * cfg.n_layers for slot, _, _ in _LAYER_MAP.values()
    }
    tree: Dict[str, Any] = {}
    for lpath, name, leaf in _leaves(path, cfg):
        if lpath:
            per_layer[name][lpath[0]] = leaf
        else:
            tree[name] = leaf
    tree["blocks"] = {k: np.stack(v) for k, v in per_layer.items()}
    return tree, cfg


@torch.no_grad()
def load_hf_shard(path: str, device: DeviceLike, rank: int, tp: int,
                  dtype: str = "bfloat16"
                  ) -> Tuple[Transformer, ModelConfig]:
    """(rank ``rank``'s exact-TP shard, cfg) of a local HF Llama
    checkpoint, bit for bit the cut of :func:`load_hf_checkpoint`'s
    model (``tp_sharding.shard_params``) without the whole model on any
    rank: each leaf is read, converted and placed on ``device`` on its
    own, a column-sharded ``[in, out]`` projection as its rank's rows of
    HF's ``[out, in]`` tensor, so host memory holds one leaf and the
    device only the shard."""
    from seldon_tpu_torch.models import tp_sharding
    from seldon_tpu_torch.models.convert import _to_torch

    device = resolve_device(device)
    cfg = checkpoint_config(path, dtype)
    tp_sharding.validate(cfg, tp)
    dtypes = tp_sharding.leaf_dtypes(cfg)

    def cols(lpath, name):
        if tp_sharding.leaf_spec(cfg, lpath, name) is None or tp <= 1:
            return None
        n = {"wq": cfg.n_heads * cfg.head_dim,
             "wk": cfg.n_kv_heads * cfg.head_dim,
             "wv": cfg.n_kv_heads * cfg.head_dim}.get(name, cfg.d_ff) // tp
        return rank * n, (rank + 1) * n

    held = {(lpath, name): _to_torch(leaf, dtypes[(lpath, name)]).to(device)
            for lpath, name, leaf in _leaves(path, cfg, cols)}
    shard = tp_sharding.build_shard(
        cfg, lambda lpath, name, spec: held.get((lpath, name)))
    logger.info("loaded rank %d/%d of HF checkpoint %s on %s", rank, tp,
                path, device)
    return shard, cfg


def load_hf_checkpoint(path: str, device: DeviceLike = None,
                       dtype: str = "bfloat16"
                       ) -> Tuple[Transformer, ModelConfig]:
    """(params, cfg) from a local HF Llama checkpoint directory: the
    port's :class:`Transformer` in ``dtype`` (bfloat16 or float32, as the
    JAX loader's ``dtype``; norms f32) on ``device`` (``cuda`` unless the
    caller asks for another), and its config with that compute dtype."""
    tree, cfg = hf_tree(path, dtype)
    params = params_from_numpy(tree, cfg, device)
    logger.info(
        "loaded HF checkpoint: %d layers, d_model=%d, vocab=%d (%s) on %s",
        cfg.n_layers, cfg.d_model, cfg.vocab_size, dtype, params.device,
    )
    return params, cfg
