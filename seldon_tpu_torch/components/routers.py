"""Multi-armed-bandit routers — port of
``seldon_tpu/components/routers.py``, numpy only.

``EpsilonGreedy`` routes to the best branch with probability 1 - epsilon,
else to a uniformly random one, and ``send_feedback`` updates the
per-branch running mean rewards; ``ThompsonSampling`` samples each
branch's Beta-Bernoulli posterior. State is plain picklable attributes, so
the persistence layer (runtime/persistence.py) checkpoints it across
restarts."""

from __future__ import annotations

import logging
import threading
from typing import Iterable, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class EpsilonGreedy:
    def __init__(
        self,
        n_branches: int = 2,
        epsilon: float = 0.1,
        seed: Optional[int] = None,
        verbose: bool = False,
    ):
        if n_branches < 1:
            raise ValueError("n_branches must be >= 1")
        self.n_branches = int(n_branches)
        self.epsilon = float(epsilon)
        self.verbose = bool(verbose)
        self.branch_reward_sum = [0.0] * self.n_branches
        self.branch_count = [0] * self.n_branches
        self.best_branch = 0
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def route(self, features: np.ndarray, feature_names: Iterable[str]) -> int:
        with self._lock:
            if self._rng.random() < self.epsilon:
                branch = int(self._rng.integers(self.n_branches))
            else:
                branch = self.best_branch
        if self.verbose:
            logger.info("epsilon-greedy routing to %d", branch)
        return branch

    def send_feedback(
        self, features, feature_names, reward: float, truth,
        routing: Optional[int] = None,
    ) -> None:
        if routing is None or not (0 <= routing < self.n_branches):
            return
        with self._lock:
            self.branch_reward_sum[routing] += float(reward)
            self.branch_count[routing] += 1
            means = [
                (self.branch_reward_sum[i] / self.branch_count[i])
                if self.branch_count[i]
                else 0.0
                for i in range(self.n_branches)
            ]
            self.best_branch = int(np.argmax(means))

    def metrics(self) -> List[dict]:
        return [
            {"type": "GAUGE", "key": f"bandit_branch_{i}_mean_reward",
             "value": (self.branch_reward_sum[i] / self.branch_count[i])
             if self.branch_count[i] else 0.0}
            for i in range(self.n_branches)
        ]

    def tags(self) -> dict:
        return {"router": "epsilon-greedy", "best_branch": self.best_branch}

    # Lock objects don't pickle; drop and rebuild across persistence.
    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_lock", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()


class ThompsonSampling:
    """Beta-Bernoulli posterior sampling. Rewards are interpreted as
    success probabilities in [0, 1] (clipped), matching the reference."""

    def __init__(
        self,
        n_branches: int = 2,
        alpha: float = 1.0,
        beta: float = 1.0,
        seed: Optional[int] = None,
    ):
        if n_branches < 1:
            raise ValueError("n_branches must be >= 1")
        self.n_branches = int(n_branches)
        self.successes = [float(alpha)] * self.n_branches
        self.failures = [float(beta)] * self.n_branches
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def route(self, features: np.ndarray, feature_names: Iterable[str]) -> int:
        with self._lock:
            samples = [
                self._rng.beta(self.successes[i], self.failures[i])
                for i in range(self.n_branches)
            ]
        return int(np.argmax(samples))

    def send_feedback(
        self, features, feature_names, reward: float, truth,
        routing: Optional[int] = None,
    ) -> None:
        if routing is None or not (0 <= routing < self.n_branches):
            return
        r = float(np.clip(reward, 0.0, 1.0))
        with self._lock:
            self.successes[routing] += r
            self.failures[routing] += 1.0 - r

    def metrics(self) -> List[dict]:
        return [
            {"type": "GAUGE", "key": f"bandit_branch_{i}_posterior_mean",
             "value": self.successes[i] / (self.successes[i] + self.failures[i])}
            for i in range(self.n_branches)
        ]

    def tags(self) -> dict:
        return {"router": "thompson-sampling"}

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_lock", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()
