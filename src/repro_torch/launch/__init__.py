# Launch layer: the serving driver (launch/serve.py), counterpart of
# repro/launch/serve.py. Importing it touches no device.
