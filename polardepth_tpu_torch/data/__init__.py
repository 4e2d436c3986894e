"""Data of the port: synthetic scenes, the HAMMER loader, the batch
pipeline and the on-device augmentation."""
