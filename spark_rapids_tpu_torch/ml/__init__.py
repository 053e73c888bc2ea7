"""ML integration (port of spark_rapids_tpu/ml/; reference
`ColumnarRdd.scala`, `docs/ml-integration.md`): a query's columnar
output handed to PyTorch ML code as tensors that stay on the card."""
from spark_rapids_tpu_torch.ml.columnar_rdd import ColumnarRdd

__all__ = ["ColumnarRdd"]
