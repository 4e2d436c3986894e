"""On-device data augmentation of the port."""
