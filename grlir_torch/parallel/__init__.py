"""Data parallelism over processes, one a device (counterpart of
`grlir.parallel`): `launch` joins the process group, `mesh` describes the
world and holds the collectives the trainers, the evaluation and the
Restorer use."""
