"""Command-line smokes and benchmarks of the port, run as modules
(``python -m moolib_tpu_torch.tools.<name>``); the twins of the
reference's ``tools/`` scripts of the same names."""
