from repro_torch.data.synthetic import (
    SyntheticClassificationDataset,
    make_classification_data,
    make_lm_stream,
)
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.loader import FederatedData, batch_iterator

__all__ = [
    "SyntheticClassificationDataset",
    "make_classification_data",
    "make_lm_stream",
    "dirichlet_partition",
    "iid_partition",
    "FederatedData",
    "batch_iterator",
]
