"""The plain reference of the benchmark: frozen copies of the port's exact
(float64) encoders and host packers, which import nothing of the port and
nothing of JAX (see mp2/model.py and dabplus/model.py), and the two stream
references that re-encode the sampled stations from the same inputs
(mp2_stream.py, dabplus_stream.py)."""
