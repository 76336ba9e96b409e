"""Launchers: the (pod, data, model) mesh and the GLM epoch programs
bound to it (`launch.glm.make_sparse_epoch`); the LM's parameter
initialisation and prefill/decode steps (`launch.steps`) and the LM
serving entry point (`launch.serve.serve`)."""
