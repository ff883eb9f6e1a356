"""Cost extraction: FLOPs, bytes and peak memory of a step the port runs
(twin of ``repro.core.hlo``)."""
