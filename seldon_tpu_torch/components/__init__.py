"""Graph components: bandit routers, outlier detectors and explainers —
port of ``seldon_tpu/components/__init__.py``.

The epsilon-greedy and Thompson-sampling routers (ROUTER units whose state
survives restarts through the persistence layer); outlier detectors usable
either as MODEL (predict returns scores) or TRANSFORMER (transform_input
tags outliers into meta.tags and scores into custom metrics): the
Mahalanobis and z-score detectors in numpy, and the learned VAE,
isolation-forest and Seq2Seq-LSTM detectors scored on the device; and the
explainers (integrated gradients on the device, occlusion against any
predictor, and the deployed explainer unit).
"""

from seldon_tpu_torch.components.explainers import (ExplainerServer,
                                                    IntegratedGradients,
                                                    OcclusionExplainer)
from seldon_tpu_torch.components.outliers import (MahalanobisDetector,
                                                  ZScoreDetector)
from seldon_tpu_torch.components.outliers_learned import (
    IsolationForestDetector, Seq2SeqLSTMDetector, VAEDetector)
from seldon_tpu_torch.components.routers import (EpsilonGreedy,
                                                 ThompsonSampling)

__all__ = [
    "EpsilonGreedy",
    "ThompsonSampling",
    "MahalanobisDetector",
    "ZScoreDetector",
    "VAEDetector",
    "IsolationForestDetector",
    "Seq2SeqLSTMDetector",
    "IntegratedGradients",
    "OcclusionExplainer",
    "ExplainerServer",
]
