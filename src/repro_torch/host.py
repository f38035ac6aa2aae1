"""The host side's one thread count.

Every host thread pool of the port (the checkpoint codec's leaves, the
pencil polish's row chunks, the restore's decodes) is sized from
:data:`THREADS`: numpy's FFTs and elementwise loops, the base codecs' passes
and zlib release the interpreter lock, so these stages overlap in threads.
"""

import os

#: threads of each host pool
THREADS = min(8, os.cpu_count() or 1)
