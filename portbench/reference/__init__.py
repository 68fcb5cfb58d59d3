"""The benchmark's plain reference of the stereo_matcher graph: what the
graph publishes for one raw pair, worked out again in plain PyTorch and
NumPy from the configuration and the raw pair alone.

Frozen copies of the port's plain torch twins (the port's own tests hold
those to the JAX package); nothing here imports the port or JAX, and
nothing takes a map, a table or a scale that the program made: the
rectification maps and Q come from the configuration's rig again
(:mod:`portbench.reference.rectify`). A configuration's matcher is found
by its algorithm's name in :mod:`portbench.reference.matchers`.
"""
