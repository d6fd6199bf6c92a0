"""Checkpoint save/restore in orbax's layout — port of
``seldon_tpu/servers/checkpoint.py``.

A checkpoint directory is what the JAX package's ``save_checkpoint``
writes:

    <dir>/config.json   ModelConfig fields
    <dir>/params/       orbax PyTree checkpoint: ``_METADATA`` (the tree's
                        leaf paths), an OCDBT store (``manifest.ocdbt``,
                        ``d/``, ``ocdbt.process_<i>/``) holding one zarr v2
                        array per leaf, named by its tree path joined by "."
    <dir>/tokenizer.*   optional HF tokenizer files

The port reads it with its own readers (``servers/ocdbt.py``,
``servers/zarr_v2.py``, the zstd decoder of ``servers/zstd.py``) and
imports none of jax, orbax, tensorstore or zstandard. Leaves are read one
at a time and each host buffer is dropped before the next, so the host
holds one leaf (a llama3-8b ``w_gate`` is 3.76 GB) beside the model being
filled. An int8 tree (``config.json`` says ``weight_dtype="int8"``, as the
JAX skeleton quantizes) carries each quantized leaf beside its
``*_scale`` sibling.

:func:`save_checkpoint` writes a directory the JAX package's
``load_checkpoint`` restores bit-equal: each leaf one chunk, each chunk one
zstd frame of raw blocks (valid RFC 8878, so ``.zarray`` keeps orbax's
``zstd`` compressor) in a data file of its own, one uncompressed OCDBT leaf
node, and only the orbax metadata the restore reads (``_METADATA``,
``_sharding``, ``_CHECKPOINT_METADATA``). The values are equal to JAX's;
the files are larger, since the frames are stored, not compressed (JAX's
zstd level 1 shrinks random bf16 to ~78%).
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
import shutil
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from seldon_tpu_torch.device import DeviceLike, resolve_device
from seldon_tpu_torch.models import quantize, tp_sharding
from seldon_tpu_torch.models.config import ModelConfig, get_config
from seldon_tpu_torch.models.transformer import Transformer
from seldon_tpu_torch.servers import ocdbt, zarr_v2, zstd

_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
# torch dtype -> the zarr dtype orbax writes for it.
_ZARR_DTYPE = {torch.bfloat16: "bfloat16", torch.float32: "<f4",
               torch.int8: "|i1"}


def load_config(path: str) -> ModelConfig:
    """The ModelConfig of checkpoint directory ``path`` (``config.json``);
    FileNotFoundError when it has none, as the JAX ``load_config``."""
    with open(os.path.join(path, "config.json")) as f:
        return get_config(ModelConfig(**json.load(f)))


def tree_paths(path: str) -> List[Tuple[str, ...]]:
    """The tree path of every leaf of ``<path>/params`` (orbax's
    ``_METADATA``), in its order."""
    with open(os.path.join(path, "params", "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr3 checkpoints are not supported "
                         "(orbax's default is zarr v2)")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: checkpoints without OCDBT are not "
                         "supported (orbax's default uses OCDBT)")
    out = []
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        if any(k.get("key_type") != 2 for k in keys):
            raise ValueError(f"{path}: leaf {keys} is not under dict keys")
        out.append(tuple(str(k["key"]) for k in keys))
    return out


def _leaf_of_tree(tree_path: Tuple[str, ...]) -> Tuple[tuple, str]:
    """(port path, name) of a JAX tree path: ``("blocks", name)`` is
    stacked over layers; ``(name,)`` is a top-level leaf."""
    if len(tree_path) == 2 and tree_path[0] == "blocks":
        return ("blocks",), tree_path[1]
    if len(tree_path) == 1:
        return (), tree_path[0]
    raise ValueError(f"unexpected leaf path {tree_path}")


def _want_dtype(cfg: ModelConfig, dtypes, path: tuple, name: str
                ) -> torch.dtype:
    """The dtype leaf ``name`` must have: its scale f32, a quantized
    weight int8 under ``weight_dtype="int8"``, else the model's own."""
    if name.endswith("_scale"):
        return torch.float32
    if cfg.weight_dtype == "int8" and name in (
            quantize._BLOCK_WEIGHTS if path else ("embed", "lm_head")):
        return torch.int8
    return dtypes[(path, name)]


def _as_tensor(a: np.ndarray, want: torch.dtype) -> torch.Tensor:
    """A leaf read by the zarr reader (C-contiguous, bf16 as ``uint16``)
    as a CPU tensor of dtype ``want`` sharing its memory (the caller's
    ``.to(device)`` copies it where a device needs one)."""
    if a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.dtype != want:
        raise TypeError(f"leaf dtype {t.dtype} does not match {want}")
    return t


@torch.no_grad()
def _load(path: str, device, rank: int, tp: int
          ) -> Tuple[Transformer, ModelConfig]:
    path = os.path.abspath(path)
    cfg = load_config(path)
    tp_sharding.validate(cfg, tp)
    device = resolve_device(device)
    leaves = tree_paths(path)
    reader = ocdbt.OcdbtReader(os.path.join(path, "params"))
    try:
        held = _read_leaves(zarr_v2.ZarrStore(reader), leaves, cfg, device,
                            rank, tp)
    finally:
        reader.close()
    model = tp_sharding.build_shard(
        cfg, lambda lpath, name, spec: held.get((lpath, name)))
    return model, cfg


def _read_leaves(store: zarr_v2.ZarrStore, leaves, cfg: ModelConfig,
                 device, rank: int, tp: int) -> Dict[tuple, torch.Tensor]:
    """(port path, name) -> tensor on ``device`` of every leaf, read one
    at a time (a column-sharded leaf as rank ``rank``'s columns of
    ``tp``)."""
    dtypes = tp_sharding.leaf_dtypes(cfg)
    held: Dict[tuple, torch.Tensor] = {}
    for tree_path in leaves:
        where, name = _leaf_of_tree(tree_path)
        layer_path = (0,) if where else ()
        cols = None
        if tp > 1 and tp_sharding.leaf_spec(cfg, layer_path, name) is not None:
            n = store.meta(".".join(tree_path)).shape[-1] // tp
            cols = (rank * n, (rank + 1) * n)
        arr = store.read(".".join(tree_path), cols)
        if where and arr.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks[{name!r}] stacks {arr.shape[0]} "
                             f"layers, config has {cfg.n_layers}")
        for lpath, a in ([((i,), arr[i]) for i in range(cfg.n_layers)]
                         if where else [((), arr)]):
            t = _as_tensor(a, _want_dtype(cfg, dtypes, lpath, name))
            if t.dtype == torch.int8:
                t = quantize._stored(name, t)
            held[(lpath, name)] = t.to(device)
        del arr
    return held


def load_checkpoint(path: str, device: DeviceLike = None
                    ) -> Tuple[Transformer, ModelConfig]:
    """-> (params, cfg) from checkpoint directory ``path``: the port's
    :class:`Transformer` on ``device`` (``cuda`` unless the caller asks
    for another), bit for bit the leaves JAX saved."""
    return _load(path, device, 0, 1)


def load_checkpoint_shard(path: str, device: DeviceLike, rank: int, tp: int
                          ) -> Tuple[Transformer, ModelConfig]:
    """(rank ``rank``'s exact-TP shard, cfg) of checkpoint ``path``, bit
    for bit the cut of :func:`load_checkpoint`'s model
    (``tp_sharding.shard_params``), without the whole model on any rank:
    a column-sharded leaf is read as its rank's columns (only the chunks
    holding them are decoded; a leaf of one chunk is decoded whole, one
    leaf at a time)."""
    return _load(path, device, rank, tp)


def _tree_leaves(params: Transformer) -> List[tuple]:
    """(JAX tree path, a function giving the leaf's stacked tensor) of
    every leaf of ``params`` in JAX's flattening order (dict keys
    sorted)."""
    out = []
    blocks = params.blocks
    for name, _ in tp_sharding._leaves(blocks[0]):
        out.append((("blocks", name),
                    lambda n=name: torch.stack([getattr(b, n)
                                                for b in blocks])))
    for name, t in tp_sharding._leaves(params):
        out.append(((name,), lambda t=t: t))
    return sorted(out, key=lambda e: e[0])


def _host_leaf(t: torch.Tensor) -> np.ndarray:
    """A leaf's C-order value on the host as numpy (bf16 as its ``uint16``
    bit pattern)."""
    host = t.detach().contiguous().cpu()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def leaf_sha256(params: Transformer) -> Dict[str, str]:
    """{JAX tree path joined by ".": SHA-256 of the leaf's C-order
    bytes} of every leaf of ``params``, blocks stacked over layers: the
    digests the JAX package's tree has when the two hold the same
    values."""
    return {".".join(p): hashlib.sha256(_host_leaf(get()).tobytes())
            .hexdigest() for p, get in _tree_leaves(params)}


def _metadata(leaves) -> dict:
    tree = {}
    for tree_path, shape in leaves:
        tree[str(tuple(tree_path))] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in tree_path],
            "value_metadata": {"value_type": "jax.Array",
                               "skip_deserialize": False,
                               "write_shape": list(shape)}}
    return {"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}


def _sharding(leaves) -> dict:
    """orbax's ``_sharding``: each leaf replicated over a one-axis mesh of
    every device (``shape [-1]``), so a restore without a mesh places it
    on whatever devices the restoring host has."""
    spec = json.dumps({"sharding_type": "NamedSharding", "shape": [-1],
                       "axis_names": ["x"], "partition_spec": []})
    return {base64.urlsafe_b64encode(".".join(p).encode()).decode(): spec
            for p, _ in leaves}


@torch.no_grad()
def save_checkpoint(path: str, params: Transformer, cfg: ModelConfig
                    ) -> None:
    """Write ``params`` and ``cfg`` as an orbax checkpoint directory at
    ``path`` (``config.json`` + ``params/``, replacing an existing
    ``params/`` as the JAX ``save_checkpoint(..., force=True)``), one leaf
    on the host at a time: each a zarr v2 array of one chunk, stored as a
    raw-block zstd frame in an OCDBT data file of its own. The JAX
    package's ``load_checkpoint`` restores it bit-equal; the files are the
    leaves' size (JAX's compressed files are ~78% of it for random
    bf16)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    started = time.time_ns()
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    final = os.path.join(path, "params")
    tmp = f"{final}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        store = ocdbt.StoreWriter(tmp)
        shapes = []
        for tree_path, get in _tree_leaves(params):
            t = get().detach()
            name = ".".join(tree_path)
            if t.dtype not in _ZARR_DTYPE:
                raise ValueError(f"leaf {name}: dtype {t.dtype} is not "
                                 "supported")
            dtype = _ZARR_DTYPE[t.dtype]
            arr = _host_leaf(t)
            del t
            shapes.append((tree_path, arr.shape))
            store.put(f"{name}/.zarray", zarr_v2.zarray(arr.shape, dtype))
            store.put(zarr_v2.chunk_key(name, (0,) * arr.ndim),
                      (zstd.raw_frame_size(arr.nbytes),
                       zstd.raw_frame_parts(arr)))
            del arr
        store.commit()
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump(_metadata(shapes), f)
        with open(os.path.join(tmp, "_sharding"), "w") as f:
            json.dump(_sharding(shapes), f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": _HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": started,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
