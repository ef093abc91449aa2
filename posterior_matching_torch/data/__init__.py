from posterior_matching_torch.data.datasets import ArrayDataset, load_datasets, load_eval_dataset
from posterior_matching_torch.data.sources import load_arrays

__all__ = ["ArrayDataset", "load_arrays", "load_datasets", "load_eval_dataset"]
