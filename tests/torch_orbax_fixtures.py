"""The JAX-written orbax fixtures under ``tests/data/torch_orbax_tiny_*``.

Each fixture is a ``tiny`` checkpoint directory the JAX package's
``save_checkpoint`` wrote (``config.json`` + ``params/``), bf16 and int8,
with ``record.json`` beside them holding every leaf's SHA-256 (its C-order
bytes), JAX's greedy streams for ``PROMPTS`` (``JAXServer(model_uri=...)``
on the ragged kernel leg)
and, at every position of each stream, the top-2 gap of JAX's logits
there (so a reader of the record can tell a near-tie from a fault without
running JAX, as chip_smoke.py's ``orbax`` round does on the card).

Rebuild them (JAX on the CPU) with:

    JAX_PLATFORMS=cpu python tests/torch_orbax_fixtures.py

``tests/test_torch_checkpoint.py`` rebuilds them into a temporary
directory and holds the values to the committed ones.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
KINDS = {"bf16": 0, "int8": 1}  # kind -> init seed
PROMPTS = [[5, 17, 99, 3], [200, 1, 42, 42, 7, 9, 250],
           list(range(10, 40))]
MAX_NEW = 8
# The serving knobs of the recorded streams (the port serves the same).
SERVER_KW = dict(max_slots=4, max_seq_len=64, prefill_chunk=16, ragged=1,
                 ragged_kernel="pallas")


def fixture_dir(kind: str) -> str:
    return os.path.join(DATA, f"torch_orbax_tiny_{kind}")


def leaf_sha256(tree) -> dict:
    """{tree path joined by ".": SHA-256 of the leaf's C-order bytes}."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(k.key for k in path)
        out[name] = hashlib.sha256(
            np.ascontiguousarray(np.asarray(leaf)).tobytes()).hexdigest()
    return out


def jax_streams(path: str) -> list:
    """``JAXServer(model_uri=path)``'s greedy streams of ``PROMPTS`` on the
    ragged kernel leg, its engine under a copying ``jnp.asarray``
    (ROADMAP.md C3: on the CPU ``jnp.asarray`` may alias the engine's
    live host block table; the copy changes no value)."""
    import jax.numpy as jnp
    import pytest

    from seldon_tpu.servers.jaxserver import JAXServer
    from torch_port_helpers import _copying

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "asarray", _copying(jnp.asarray))
        srv = JAXServer(model_uri=path, **SERVER_KW)
        srv.load()
        try:
            return [srv.generate({"prompt_token_ids": p,
                                  "max_new_tokens": MAX_NEW,
                                  "temperature": 0.0})["token_ids"]
                    for p in PROMPTS]
        finally:
            srv.engine.stop()


def build(kind: str, out: str) -> dict:
    """Write the ``kind`` fixture to directory ``out``; returns its
    record."""
    import jax
    import jax.numpy as jnp

    from seldon_tpu.models import transformer as jtf
    from seldon_tpu.models.config import get_config
    from seldon_tpu.models.quantize import quantize_params
    from seldon_tpu.servers import checkpoint as jck

    cfg = get_config("tiny")
    params = jtf.init_params(cfg, jax.random.key(KINDS[kind]))
    if kind == "int8":
        params = quantize_params(params)
        cfg = dataclasses.replace(cfg, weight_dtype="int8")
    shutil.rmtree(out, ignore_errors=True)
    jck.save_checkpoint(out, params, cfg)
    streams = jax_streams(out)
    gaps = []
    for p, s in zip(PROMPTS, streams):
        logits = np.asarray(jtf.forward(
            params, jnp.asarray([p + s], jnp.int32), cfg)[0], np.float32)
        row = []
        for i in range(len(s)):
            top = np.sort(logits[len(p) - 1 + i])[-2:]
            row.append(float(top[1] - top[0]))
        gaps.append(row)
    record = {"kind": kind, "leaves": leaf_sha256(params),
              "prompts": PROMPTS, "max_new_tokens": MAX_NEW,
              "streams": streams, "top2_gaps": gaps}
    with open(os.path.join(out, "record.json"), "w") as f:
        json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    sys.path[:0] = [os.path.dirname(HERE), HERE]
    import jax

    jax.config.update("jax_platforms", "cpu")
    for k in KINDS:
        build(k, fixture_dir(k))
        print("wrote", fixture_dir(k))
