"""Distro-consumable packaging of the native host runtime: the CMake
package (digiham_jax/native/CMakeLists.txt — the equivalent of the
reference's libdigiham CMake export, reference src/CMakeLists.txt:1-17)
must build, install, and be consumable by a downstream C++ project via
find_package, and the installed library's ABI must agree with the ctypes
binding's expectations."""
import os
import shutil
import subprocess
import sys

import pytest

NATIVE = os.path.join(os.path.dirname(__file__), "..",
                      "digiham_jax", "native")

pytestmark = pytest.mark.skipif(
    shutil.which("cmake") is None or shutil.which("g++") is None,
    reason="cmake/g++ not available")

CONSUMER_CMAKE = """
cmake_minimum_required(VERSION 3.16)
project(consumer CXX)
find_package(DigihamTpuNative REQUIRED)
add_executable(consumer consumer.cpp)
target_link_libraries(consumer PRIVATE DigihamTpuNative::digiham_native)
"""

CONSUMER_CPP = r"""
#include <digiham_native.h>
#include <cstdio>
#include <cstring>

int main() {
    // hamming distance + pack round trip + ring buffer through the
    // installed public header and shared library
    const uint8_t a[4] = {1, 3, 0, 2}, b[4] = {1, 1, 0, 2};
    if (dh_hamming_distance(a, b, 4) != 1) return 1;
    uint8_t packed[1];
    dh_pack_dibits(a, 4, packed);
    if (packed[0] != 0x72) return 2;  // 01 11 00 10
    uint8_t un[4];
    dh_unpack_dibits(packed, 4, un);
    if (memcmp(a, un, 4) != 0) return 3;
    dh_ringbuffer* rb = dh_rb_create(64);
    if (!rb) return 4;
    if (dh_rb_write(rb, packed, 1) != 1) return 5;
    uint8_t out[1];
    if (dh_rb_peek(rb, out, 1) != 1 || out[0] != 0x72) return 6;
    dh_rb_destroy(rb);
    printf("CONSUMER OK\n");
    return 0;
}
"""


def _run(cmd, **kw):
    r = subprocess.run(cmd, capture_output=True, text=True, **kw)
    assert r.returncode == 0, (cmd, r.stdout[-800:], r.stderr[-800:])
    return r


def test_cmake_package_builds_installs_and_serves_a_consumer(tmp_path):
    build = tmp_path / "build"
    prefix = tmp_path / "prefix"
    _run(["cmake", "-S", NATIVE, "-B", str(build),
          "-DCMAKE_BUILD_TYPE=Release"])
    _run(["cmake", "--build", str(build), "-j2"])
    _run(["cmake", "--install", str(build), "--prefix", str(prefix)])

    # installed surface: header, versioned lib, CMake config, pkg-config
    assert (prefix / "include" / "digiham_native.h").exists()
    libdir = next(d for d in ("lib", "lib64")
                  if (prefix / d / "cmake" / "DigihamTpuNative"
                      / "DigihamTpuNativeConfig.cmake").exists())
    assert (prefix / libdir / "pkgconfig"
            / "digiham_jax_native.pc").exists()

    consumer = tmp_path / "consumer"
    consumer.mkdir()
    (consumer / "CMakeLists.txt").write_text(CONSUMER_CMAKE)
    (consumer / "consumer.cpp").write_text(CONSUMER_CPP)
    cbuild = tmp_path / "cbuild"
    _run(["cmake", "-S", str(consumer), "-B", str(cbuild),
          f"-DCMAKE_PREFIX_PATH={prefix}"])
    _run(["cmake", "--build", str(cbuild), "-j2"])
    r = _run([str(cbuild / "consumer")])
    assert "CONSUMER OK" in r.stdout


def test_header_matches_ctypes_binding(tmp_path):
    """Every dh_* symbol the ctypes binding loads must be declared in the
    public header (the -dev contract)."""
    import re

    header = open(os.path.join(NATIVE, "include",
                               "digiham_native.h")).read()
    binding = open(os.path.join(NATIVE, "__init__.py")).read()
    used = set(re.findall(r"\bdh_[a-z0-9_]+\b", binding))
    declared = set(re.findall(r"\bdh_[a-z0-9_]+\b", header))
    missing = {s for s in used if s not in declared
               and not s.startswith("dh_ringbuffer")}
    assert not missing, f"ctypes uses symbols absent from header: {missing}"
