from repro_torch.data.synth import fashion_synth, FederatedDataset
from repro_torch.data.partition import partition_noniid_labels, partition_iid
from repro_torch.data.tokens import synthetic_token_batches

__all__ = [
    "fashion_synth", "FederatedDataset",
    "partition_noniid_labels", "partition_iid", "synthetic_token_batches",
]
