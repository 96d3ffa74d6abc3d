"""The benchmark of adaptive_sph_torch: discovery (spec), the cell's inputs
(inputs), the fixed episodes and the measured window (episodes), the
profiler's reading (trace), the reference comparison (verify), the solver
contract (contract), the roofline arithmetic (roofline) and the run
(harness)."""
