"""ray_tpu_torch.data: streaming distributed datasets (reference: Ray Data).

The port's own copy of `ray_tpu/data/`; `Dataset.iter_device_batches`
feeds the card through pinned buffers (data/_device.py)."""

from ray_tpu_torch.data.block import Block
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import (Dataset, from_items, from_numpy,
                                  from_pandas, read_csv, read_json,
                                  read_parquet)
range = Dataset.range  # noqa: A001 — mirrors ray.data.range
read_images = Dataset.read_images
read_tfrecords = Dataset.read_tfrecords
read_text = Dataset.read_text
read_binary_files = Dataset.read_binary_files
read_sql = Dataset.read_sql
from_arrow = Dataset.from_arrow

__all__ = ["Block", "Dataset", "DataContext", "from_items",
           "from_numpy", "from_pandas", "from_arrow", "read_csv",
           "read_json", "read_parquet", "read_images",
           "read_tfrecords", "read_text", "read_binary_files",
           "read_sql", "range"]
