"""A frozen copy of the port's plain path: ``config``, ``device``, ``core``
(``pipeline``, ``loop_closure``, ``posegraph``, ``preprocessing``, ``spill``,
``surfel_map``), ``ops`` (``icp``, ``pyramid``, ``projection``, ``zbuffer``,
``filters``, ``knn``), ``utils`` (``lie``, ``timing``) and ``models``
(``labels``, ``rangenet``'s network input), as the port held them when the
benchmark was written. It imports nothing of the port.

Departures from the port: kernels B, C, D, E and F are their plain
versions (``ops/zbuffer.zbuffer_cells``, ``ops/knn.knn_clean_image``,
``ops/icp.icp_products``, ``gn_update``, ``gn_loop``) and no kernel library
is loaded; the Gauss-Newton loop stops at its latch; preprocessing takes the
plain bilateral filter; the sharded paths, the per-point KNN vote and the
network's training are left out; and the network itself is
``suma_bench/nets/<arch>.py``, which takes ``float8_e4m3fn`` as a compute
type, emulated, for the benchmark's control."""
