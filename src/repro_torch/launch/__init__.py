"""Launchers: the (pod, data, model) mesh and the GLM epoch programs
bound to it (`launch.glm.make_sparse_epoch`)."""
