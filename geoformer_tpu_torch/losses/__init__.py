from geoformer_tpu_torch.losses.criterion import InstSetCriterion
from geoformer_tpu_torch.losses.criterion_fs import FSInstSetCriterion

__all__ = ["InstSetCriterion", "FSInstSetCriterion"]
