"""See the package docstring; each module mirrors its counterpart in cudatracerlib_tpu."""
