"""device_ops_per_iter.sv: ``device_ops_per_iter`` read in the SV cell,
where it moves ``samples_per_s.sv``."""
from portbench.harness import reader

read = reader("device_ops_per_iter")
