# The suite system of the port: registry (Table I), presets, plans, the
# staged engine, CUDA-event timing, roofline characterization and records.
