"""The batched imputation engine of the port."""
