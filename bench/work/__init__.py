"""The benchmark's own counts of work: model operations a training step
needs (`model`) and each hand-written kernel's operations and bytes
(`kernels`), worked out from the configuration's shapes."""
