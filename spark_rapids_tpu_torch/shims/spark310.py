"""The spark310 package (port of spark_rapids_tpu/shims/spark310.py;
reference `shims/spark310/.../RapidsShuffleManager.scala`): the
version-named shuffle manager class users put in
spark.shuffle.manager."""
from spark_rapids_tpu_torch.shuffle.manager import TpuShuffleManager


class RapidsShuffleManager(TpuShuffleManager):
    SPARK_VERSION = "spark310"
