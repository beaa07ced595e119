"""The port's utilities: champions.py is a copy of
evostencils_tpu/utils/champions.py that imports the port's IR."""
