"""Training of the port: the step, the fault-tolerant loop and npz
checkpoints in the reference's layout."""
