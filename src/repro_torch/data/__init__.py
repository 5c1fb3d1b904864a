from repro_torch.data.partition import dirichlet_labels, dirichlet_partition
from repro_torch.data.synthetic import (DATASETS, FedDataset,
                                        make_federated_dataset)

__all__ = ["DATASETS", "FedDataset", "make_federated_dataset",
           "dirichlet_labels", "dirichlet_partition"]
