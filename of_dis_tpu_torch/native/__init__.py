"""Host-side native code of the port: the serving pipeline's frame
decoder (`native.io`, on the C entries of `csrc/io_native.cpp`)."""
