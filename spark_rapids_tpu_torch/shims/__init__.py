"""Version shim layer (port of spark_rapids_tpu/shims/: the part the I/O
layer and the exchange call): what varies across the supported Spark
versions routes through a `SparkShims` instance resolved from the
session's Spark version."""
from spark_rapids_tpu_torch.shims.base import ShimVersion, SparkShims
from spark_rapids_tpu_torch.shims.loader import (current_shims,
                                                 detect_version,
                                                 get_spark_shims,
                                                 register_provider)
from spark_rapids_tpu_torch.shims.versions import (ALL_SHIMS,
                                                   Spark300dbShims,
                                                   Spark300Shims,
                                                   Spark301Shims,
                                                   Spark302Shims,
                                                   Spark310Shims)

__all__ = [
    "ShimVersion", "SparkShims", "current_shims", "detect_version",
    "get_spark_shims", "register_provider", "ALL_SHIMS",
    "Spark300Shims", "Spark300dbShims", "Spark301Shims", "Spark302Shims",
    "Spark310Shims",
]
