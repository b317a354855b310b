"""The kernel build cache of ``fdtd_tpu_torch.solver._build``, with a stand-in
for nvcc (a shell script that writes the library and prints ptxas lines), so
it runs without the CUDA toolkit."""

import stat

from fdtd_tpu_torch.solver import _build

PTXAS = "ptxas info    : Used 48 registers, used 1 barriers, 0 bytes spill stores"


def fake_nvcc(tmp_path):
    """A script taking nvcc's arguments: it writes the file after ``-o``,
    prints one ptxas line and counts its calls in ``calls``."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f"echo x >> {tmp_path / 'calls'}\n"
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then echo lib > "$2"; fi\n'
        "  shift\n"
        "done\n"
        f"echo '{PTXAS}' >&2\n")
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    return script


def test_cached_build_keeps_its_log(tmp_path, monkeypatch):
    """A second Kernel on the same sources finds the library built and still
    has the ptxas lines of its build; a library without its log is rebuilt."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    (csrc / "k.cuh").write_text("// a header\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake_nvcc(tmp_path)))

    def kernel():
        return _build.Kernel("k", "k.cu", "fdtd_k", [], csrc=csrc, build_dir=tmp_path / "b")

    first = kernel()
    lib = first.build()
    assert PTXAS in first.build_log and first.build_seconds is not None
    again = kernel()
    assert again.build() == lib
    assert again.build_log == first.build_log and again.build_seconds is None
    assert (tmp_path / "calls").read_text().count("x") == 1

    lib.with_suffix(".log").unlink()
    third = kernel()
    assert third.build() == lib and PTXAS in third.build_log
    assert (tmp_path / "calls").read_text().count("x") == 2
