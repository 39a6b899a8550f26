"""Host-side C++ kernels (`euler.cpp`), built with g++ at first use and
bound through ctypes: counterpart of `graphgpt_tpu/native/`."""
