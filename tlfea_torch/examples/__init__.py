"""The example scripts of `examples/`, ported (`python -m
tlfea_torch.examples.<name>`). Each takes the JAX script's options plus
`--device` (default cuda) and `--dtype` (default float32), and writes the
same CSV and VTU files under `out/<name>/` of the working directory."""
