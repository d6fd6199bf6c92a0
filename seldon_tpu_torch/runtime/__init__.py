from seldon_tpu_torch.runtime.user_model import (SeldonComponent,
                                                 SeldonNotImplementedError)

__all__ = ["SeldonComponent", "SeldonNotImplementedError"]
