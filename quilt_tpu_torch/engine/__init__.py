"""The imputation engines of the port: batched (batch.py) and per-sample (sample.py)."""
