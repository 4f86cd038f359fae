"""config of the PyTorch port: the YAML reader, interpolation, instantiation and the class_path registry."""
