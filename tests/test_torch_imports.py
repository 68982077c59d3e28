"""The port stands alone: it imports neither JAX nor the JAX package,
and its entry points never fall back to the CPU on their own."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import gubernator_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gubernator_tpu_torch")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG], prefix="gubernator_tpu_torch.")
    )


def test_every_module_imports_with_jax_absent():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        "import gubernator_tpu_torch\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "assert not any(k == 'gubernator_tpu' or k.startswith('gubernator_tpu.') for k in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_global_plane_modules_are_covered():
    """The GLOBAL, persistence and one-shard store modules (the K10
    binding lives in ops._kernels), the serving tier's leaf modules and
    the HTTP edge's (ring, audit, profiling, telemetry, the pb modules,
    wire, gateway) and the daemon's (metrics, tls, grpc_server, peers,
    daemon, client, the cmd binaries) and the peers slice's (faults,
    peer_client, cluster) and the federation and discovery slice's
    (federation, gossip, etcd_pool, k8s_pool, the etcd pb modules) and
    the incident black box (blackbox) are among those the two checks above import with JAX absent and scan for
    imports."""
    mods = set(_modules())
    for m in ("ops.global_ops", "parallel.global_mgr", "utils.interval",
              "parallel.mesh", "service", "ops._kernels", "store", "reshard",
              "snapshot", "models.shard", "models.slot_table", "ops.scalar",
              "config", "utils.logging", "utils.batch_window", "tracing",
              "saturation", "utils.net", "parallel.hash_ring", "parallel.region",
              "audit", "profiling", "telemetry", "proto", "proto.gubernator_pb2",
              "proto.peers_pb2", "proto.peers_columns_pb2", "wire", "gateway",
              "metrics", "tls", "grpc_server", "peers", "daemon", "client",
              "cmd", "cmd.server", "cmd.cli", "cmd.cluster_main",
              "faults", "peer_client", "cluster", "federation", "gossip",
              "etcd_pool", "k8s_pool", "proto.etcd_kv_pb2", "proto.etcd_rpc_pb2",
              "blackbox"):
        assert f"gubernator_tpu_torch.{m}" in mods, m


def test_peer_modules_import_without_grpc():
    """The peers slice's modules (and the service that builds peer
    clients) import neither JAX nor grpc: a node speaking HTTP to its
    peers needs no grpc, and the gRPC transport imports it at its first
    call."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import gubernator_tpu_torch.faults, gubernator_tpu_torch.peer_client\n"
        "import gubernator_tpu_torch.cluster, gubernator_tpu_torch.reshard\n"
        "import gubernator_tpu_torch.service\n"
        "bad = [k for k, v in sys.modules.items()\n"
        "       if v is not None and k.split('.')[0] in ('grpc', 'jax', 'gubernator_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_discovery_and_http_path_import_without_grpc():
    """The federation plane, gossip, k8s discovery, `peers.make_pool`,
    the service and the HTTP edge import no grpc: only the etcd pool does, and
    make_pool imports it only when etcd is chosen.  The etcd pb copies
    import with JAX absent and the JAX package unloaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import gubernator_tpu_torch.federation, gubernator_tpu_torch.gossip\n"
        "import gubernator_tpu_torch.k8s_pool, gubernator_tpu_torch.peers\n"
        "import gubernator_tpu_torch.gateway, gubernator_tpu_torch.service\n"
        "bad = [k for k, v in sys.modules.items()\n"
        "       if v is not None and k.split('.')[0] in ('grpc', 'jax', 'gubernator_tpu')]\n"
        "assert not bad, bad\n"
        "import gubernator_tpu_torch.etcd_pool, gubernator_tpu_torch.proto.etcd_rpc_pb2\n"
        "assert 'grpc' in sys.modules\n"
        "assert not any(k.split('.')[0] in ('jax', 'gubernator_tpu') for k, v in sys.modules.items()\n"
        "               if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_or_reference_imports_in_sources():
    scripts = os.path.join(ROOT, "scripts")
    files = [os.path.join(ROOT, "chip_smoke.py")] + sorted(
        os.path.join(scripts, n) for n in os.listdir(scripts)
        if n.startswith("torch_") and n.endswith(".py"))
    assert {"torch_rounds_ab.py", "torch_serve_ab.py"} <= {os.path.basename(f) for f in files}
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        roots = set(_imported_roots(f))
        assert "jax" not in roots and "jaxlib" not in roots, f
        assert "gubernator_tpu" not in roots, f


def test_blackbox_and_port_scripts_load_without_jax():
    """blackbox.py and every scripts/torch_*.py load (their mains not
    run) with JAX absent, and neither JAX nor the JAX package is in
    sys.modules afterwards."""
    scripts = os.path.join(ROOT, "scripts")
    names = sorted(n for n in os.listdir(scripts) if n.startswith("torch_") and n.endswith(".py"))
    assert {"torch_replay.py", "torch_blackbox_fsck.py", "torch_incident_collect.py",
            "torch_snapshot_fsck.py", "torch_soak.py", "torch_long_soak.py",
            "torch_check_metrics_parity.py"} <= set(names)
    code = (
        "import sys, importlib.util, os\n"
        "sys.modules['jax'] = None\n"
        "import gubernator_tpu_torch.blackbox\n"
        f"for n in {names!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(n[:-3], os.path.join({scripts!r}, n))\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [k for k, v in sys.modules.items() if v is not None\n"
        "       and k.split('.')[0] in ('jax', 'jaxlib', 'gubernator_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_store_without_device_raises_without_a_gpu():
    import torch

    from gubernator_tpu_torch.parallel.mesh import MeshBucketStore
    from gubernator_tpu_torch.service import ServiceConfig, V1Service

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshBucketStore(capacity_per_shard=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V1Service(ServiceConfig(cache_size=64))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrappers themselves take CUDA tensors only: a CPU
    tensor reaches the plain version through the dispatch wrapper,
    never the kernel binding."""
    import torch

    from gubernator_tpu_torch.ops import _kernels

    from gubernator_tpu_torch.ops import global_ops

    hot = torch.zeros((8, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.bucket_rounds_dict(hot, hot.clone(), torch.zeros((8, 3 * 64 + 3072), dtype=torch.int32),
                                    1, 0, False)
    gcols = global_ops.init_global_columns(8, 16, "cpu")
    lanes = torch.zeros((8, 6, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.global_answer_rounds(hot, hot.clone(), gcols, lanes,
                                      torch.zeros((8, 5, 64), dtype=torch.int64),
                                      torch.zeros((8, 64), dtype=torch.int32), 1, 0)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.global_sync(hot, hot.clone(), gcols, torch.zeros((8, 16), dtype=torch.int64),
                             torch.zeros((8, 16), dtype=torch.bool), 0)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.set_replica(gcols, torch.zeros((5, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.clear_gslots(gcols, torch.zeros(8, dtype=torch.int64))
    lanes = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.gather_rows(hot, hot.clone(), lanes)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.write_rows(hot, hot.clone(), lanes, lanes.clone(),
                            torch.zeros((5, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.apply_moves(hot, hot.clone(), hot.clone(), hot.clone(),
                             torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.bucket_compact(hot, hot.clone(), torch.zeros((8, 4), dtype=torch.int32), 0,
                                wire=torch.zeros((8, 3 * 64 + 3072), dtype=torch.int32))
    assert set(_kernels.LAUNCHES) == {
        "bucket_rounds_dict", "bucket_rounds_cols", "global_answer_rounds",
        "global_sync", "set_replica", "clear_gslots", "gather_rows", "write_rows",
        "gather_back_rows", "apply_moves", "bucket_compact"}
    assert not any(_kernels.LAUNCHES.values())


def test_native_fnv1a_matches_python_hash():
    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.utils import hashing

    keys = [f"name_key{i}" for i in range(200)] + ["", "ü-ñ"]
    got = native.fnv1_batch(keys)
    want = np.array([hashing.hash_string_64(k) for k in keys], np.uint64)
    np.testing.assert_array_equal(got, want)


def test_package_exports_types():
    assert gubernator_tpu_torch.Algorithm.LEAKY_BUCKET == 1
    assert gubernator_tpu_torch.__version__


def test_every_kernel_source_is_built_and_bound():
    """Each csrc/*.cu (compact.cu's K10 included) is among the sources
    the build compiles, and each of its C entry points has a ctypes
    signature in ops/_kernels.py."""
    import re

    from gubernator_tpu_torch.ops import _kernels

    csrc = os.path.join(PKG, "csrc")
    cu = sorted(n for n in os.listdir(csrc) if n.endswith(".cu"))
    assert "compact.cu" in cu
    assert cu == sorted(os.path.basename(p) for p in _kernels.SOURCES)
    for name in cu:
        text = open(os.path.join(csrc, name)).read()
        entry = re.findall(r"^int (gt_\w+)\(", text.split('extern "C"')[1], re.M)
        assert entry and set(entry) <= set(_kernels._SIGNATURES), (name, entry)
