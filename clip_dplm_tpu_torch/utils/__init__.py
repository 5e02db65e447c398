"""Weight conversion from the JAX package's flax trees, pretrained bundles,
logging, and the precision policy."""
from clip_dplm_tpu_torch.utils.precision import DTYPES, Policy  # noqa: F401
