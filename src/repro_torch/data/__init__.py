"""The data pipeline; port of `repro.data`."""
