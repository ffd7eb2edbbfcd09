from ctr_recommendation_tpu_torch.data.device_store import DeviceItemStore
from ctr_recommendation_tpu_torch.data.item_store import ItemStore
from ctr_recommendation_tpu_torch.data.parquet import TableData, iter_batches, load_split
from ctr_recommendation_tpu_torch.data.prefetch import prefetch
from ctr_recommendation_tpu_torch.data.streaming import stream_batches
from ctr_recommendation_tpu_torch.data.synthetic import (
    fake_batch,
    make_synthetic_tables,
    synthetic_splits,
    write_synthetic_dataset,
)

__all__ = [
    "DeviceItemStore",
    "ItemStore",
    "TableData",
    "fake_batch",
    "iter_batches",
    "load_split",
    "make_synthetic_tables",
    "prefetch",
    "stream_batches",
    "synthetic_splits",
    "write_synthetic_dataset",
]
