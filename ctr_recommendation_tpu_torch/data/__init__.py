from ctr_recommendation_tpu_torch.data.device_store import DeviceItemStore
from ctr_recommendation_tpu_torch.data.item_store import ItemStore
from ctr_recommendation_tpu_torch.data.parquet import TableData, load_split
from ctr_recommendation_tpu_torch.data.synthetic import (
    make_synthetic_tables,
    synthetic_splits,
    write_synthetic_dataset,
)

__all__ = [
    "DeviceItemStore",
    "ItemStore",
    "TableData",
    "load_split",
    "make_synthetic_tables",
    "synthetic_splits",
    "write_synthetic_dataset",
]
