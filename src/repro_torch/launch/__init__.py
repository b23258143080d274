"""The port's launch layer (counterpart of `repro.launch`): the train-step
factories and the CLI, `launch.train`."""
