"""End-user modulator models: the JAX equivalents of the reference's
blade scripts (dvbt-blade.py, dvbt2-blade.py, qam-blade.py) with matching
argv surfaces, minus SDR hardware output (IQ file sink only)."""
