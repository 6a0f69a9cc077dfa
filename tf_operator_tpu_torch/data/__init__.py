"""The on-disk input path of the PyTorch port: counterpart of
tf_operator_tpu/data (dataset.py, prefetch.py, staging.py)."""
