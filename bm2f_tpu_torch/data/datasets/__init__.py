from bm2f_tpu_torch.data.datasets.builtin import register_all_builtin_datasets

__all__ = ["register_all_builtin_datasets"]
