"""The training data pipeline (counterpart of ``repro/data``)."""
