"""Training of the port: the step, the fault-tolerant loop, npz
checkpoints in the reference's layout and training on a mesh."""
