"""device_idle_share.sv: ``device_idle_share`` read in the SV cell,
where it moves ``samples_per_s.sv``."""
from portbench.harness import reader

read = reader("device_idle_share")
