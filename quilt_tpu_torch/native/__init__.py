"""Native C++ IO/compute engine sources (quilt_io.cpp).

The shared library builds from these sources on first import
(io/native.py) or at wheel build time (setup.py); every entry point has a
pure-Python fallback.
"""
