"""Datasets: host batches and on-device augmentation."""
