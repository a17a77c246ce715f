"""data (port of kinfu_tpu/data/)."""

from kinfu_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticScene,
    sphere,
    plane,
    box,
    make_orbit_trajectory,
    make_translation_trajectory,
)
from kinfu_tpu_torch.data.bundled import BundledDataset  # noqa: F401
from kinfu_tpu_torch.data.tum import TUMDataset  # noqa: F401
