"""Model code of the port: the dense decoder path of the map lane."""
