from ctr_recommendation_tpu_torch.data.device_store import DeviceItemStore
from ctr_recommendation_tpu_torch.data.item_store import ItemStore
from ctr_recommendation_tpu_torch.data.parquet import TableData

__all__ = ["DeviceItemStore", "ItemStore", "TableData"]
