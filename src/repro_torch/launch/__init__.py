"""The port's launch layer (counterpart of `repro.launch`): the train-step
factories and the CLI, `launch.train`, and the mesh with its logical-axis
rules, `launch.mesh`."""
