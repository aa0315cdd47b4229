from repro_torch.data.synth import fashion_synth, FederatedDataset
from repro_torch.data.partition import partition_noniid_labels, partition_iid

__all__ = [
    "fashion_synth", "FederatedDataset",
    "partition_noniid_labels", "partition_iid",
]
