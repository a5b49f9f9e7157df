"""The paper's own pipeline configuration (configs/cmax_camel.py). The LM
architecture registry of the reference is not ported yet."""
