"""Launch-time cost model of the port: the H100's roofline, per-cell plans,
the closed-form estimator, meta-device input specs, the production mesh
over a fake process group, a tally of the port's own program
(`op_stats`), the dry run over every cell and the verification run on the
card (`dryrun`); the port of `repro.launch`."""
