"""The plain reference that decides ``correct``.

Plain PyTorch: it imports nothing of the program and works out every
quantization error, bound and pencil again from the inputs that the
benchmark made.  :mod:`.quantize` is each client's quantizer as its
contract states it, in float32; :mod:`.pocs` the alternating projection in
float64; :mod:`.judge` the numbers compared; :mod:`.control` the same
correction with its state rounded to bfloat16, which the comparison has to
refuse.
"""
