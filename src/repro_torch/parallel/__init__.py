"""Batch layout for serving: ``sharding.pad_batch``."""
