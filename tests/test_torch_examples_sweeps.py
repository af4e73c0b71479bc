"""The port's sweep and mesh examples (``cvmatrix_tpu_torch.examples``)
beside the JAX package's, each pair in subprocesses on the CPU: probes at
1e-8 relative, the routing A/B's parity, the mesh example's shapes (the JAX
one over 8 virtual devices, the port's over two gloo ranks)."""

import re

from ._examples import assert_close, run_pair


def test_total_cv_fused_probe():
    jax, port = run_pair("total_cv_fused")
    probe = re.compile(r"probe=(\S+)$")
    assert_close(probe.search(port[-1]).group(1),
                 probe.search(jax[-1]).group(1))
    assert port[-1].startswith("total CV (fit + 100 folds)")


def test_kernel_routing_ab_probes_and_parity():
    jax, port = run_pair("kernel_routing_ab")
    assert port[0] == jax[0]  # the active policy, field for field
    for j, p in zip(jax[1:3], port[1:3]):
        assert p[:28] == j[:28]
        assert_close(p.split("probe=")[1], j.split("probe=")[1])
    assert port[3] == jax[3] == "parity OK: both routes produce the same probe"


def test_training_matrices_mesh_shapes():
    jax, port = run_pair(
        "training_matrices_mesh",
        jax_env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    shape = re.compile(r"\(\d+(?:, \d+)*\)")
    assert port[0] == "mesh: {'rows': 2} over 2 cpu ranks"
    for j, p in zip(jax[1:], port[1:]):
        assert p.split(" sharding")[0] == j.split(" sharding")[0]
        assert shape.findall(p)[0] == shape.findall(j)[0]
    assert len(port) == len(jax) == 4
