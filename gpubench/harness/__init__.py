"""The benchmark's machinery: cells resolved by name, inputs and weights
made from the seed, the measured window, the trace and the judgement."""
