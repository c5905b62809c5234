"""Plain float64 NumPy reference of the modem, independent of the program.

It imports nothing of ``color_modem_tpu`` and takes nothing it made: the
filter taps, phase ramps and colour matrices are designed here from the
published constants and design settings in the configuration file
(``benchmark/configs/<config>.json``).  The benchmark compares what its
timed path produced against :func:`modem.encode` and :func:`modem.decode`.
"""
