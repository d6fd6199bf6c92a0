"""Graph components: bandit routers and outlier detectors — port of
``seldon_tpu/components/__init__.py``.

The epsilon-greedy and Thompson-sampling routers (ROUTER units whose state
survives restarts through the persistence layer) and the Mahalanobis and
z-score outlier detectors (MODEL: predict returns scores; TRANSFORMER:
transform_input tags outliers into meta.tags and scores into custom
metrics). The learned detectors and the explainers of the JAX package
(``outliers_learned.py``, ``explainers.py``) are ROADMAP.md item A13.
"""

from seldon_tpu_torch.components.outliers import (MahalanobisDetector,
                                                  ZScoreDetector)
from seldon_tpu_torch.components.routers import (EpsilonGreedy,
                                                 ThompsonSampling)

__all__ = [
    "EpsilonGreedy",
    "ThompsonSampling",
    "MahalanobisDetector",
    "ZScoreDetector",
]
