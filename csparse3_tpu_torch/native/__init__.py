"""ctypes binding of the native host kernels (``native/`` at the repo
root), built at first use."""
