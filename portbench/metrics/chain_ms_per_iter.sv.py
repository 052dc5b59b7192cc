"""chain_ms_per_iter.sv: ``chain_ms_per_iter`` read in the SV cell,
where it moves ``samples_per_s.sv``."""
from portbench.harness import reader

read = reader("chain_ms_per_iter")
