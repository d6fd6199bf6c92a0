"""Mutable unit-state checkpointing (bandit posteriors, online stats).

Port of seldon_tpu/runtime/persistence.py: the user object is pickled to
the key `persistence_{deployment}_{predictor}_{unit}` every 60 s on a
daemon thread and restored on boot. The default backend is a local file
under `SELDON_TPU_STATE_DIR` (default: `seldon-tpu-state` in the
temporary directory); Redis is used when REDIS_SERVICE_HOST is set AND
the redis client is importable, with the same key naming, so state
moves between the two."""

from __future__ import annotations

import logging
import os
import pickle
import tempfile
import threading
from typing import Any, Optional

logger = logging.getLogger(__name__)

DEFAULT_PUSH_FREQUENCY_S = 60.0
_STATE_DIR = os.environ.get(
    "SELDON_TPU_STATE_DIR",
    os.path.join(tempfile.gettempdir(), "seldon-tpu-state"))


def state_key() -> str:
    dep = os.environ.get("SELDON_DEPLOYMENT_ID", "dep")
    pred = os.environ.get("PREDICTOR_ID", "predictor")
    unit = os.environ.get("PREDICTIVE_UNIT_ID", "unit")
    return f"persistence_{dep}_{pred}_{unit}"


def _redis_client():
    if not os.environ.get("REDIS_SERVICE_HOST"):
        return None
    try:
        import redis
    except ImportError:
        return None
    return redis.StrictRedis(
        host=os.environ["REDIS_SERVICE_HOST"],
        port=int(os.environ.get("REDIS_SERVICE_PORT", "6379")),
    )


def _file_path() -> str:
    os.makedirs(_STATE_DIR, exist_ok=True)
    return os.path.join(_STATE_DIR, state_key() + ".pkl")


def persist(user_obj: Any) -> None:
    data = pickle.dumps(user_obj)
    r = _redis_client()
    if r is not None:
        r.set(state_key(), data)
        return
    tmp = _file_path() + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, _file_path())  # atomic swap: no torn reads on crash


def restore(user_obj: Any) -> Optional[Any]:
    """Returns the restored object, or None if no state exists."""
    r = _redis_client()
    data = None
    if r is not None:
        data = r.get(state_key())
    elif os.path.exists(_file_path()):
        with open(_file_path(), "rb") as f:
            data = f.read()
    if not data:
        return None
    try:
        obj = pickle.loads(data)
        logger.info("restored unit state for %s", state_key())
        return obj
    except Exception:
        logger.exception("state restore failed; starting fresh")
        return None


class _PersistThread(threading.Thread):
    def __init__(self, user_obj: Any, frequency_s: float):
        super().__init__(daemon=True)
        self.user_obj = user_obj
        self.frequency_s = frequency_s
        self._stop_event = threading.Event()

    def run(self):
        while not self._stop_event.wait(self.frequency_s):
            try:
                persist(self.user_obj)
            except Exception:
                logger.exception("periodic persist failed")

    def stop(self):
        self._stop_event.set()
        try:
            persist(self.user_obj)  # final flush
        except Exception:
            logger.exception("final persist failed")


def start_persist_thread(
    user_obj: Any, frequency_s: Optional[float] = None
) -> _PersistThread:
    freq = frequency_s or float(
        os.environ.get("PERSISTENCE_PUSH_FREQUENCY", DEFAULT_PUSH_FREQUENCY_S)
    )
    t = _PersistThread(user_obj, freq)
    t.start()
    return t
