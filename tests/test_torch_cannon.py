"""The Cannon layer (o1vm/cannon.py, elf.py, cli.py) on the CPU, against the
JAX package's, at the inputs of tests/test_cannon.py and tests/test_mips.py:
  - the state JSON byte for byte the JAX package's, and its round trip;
    preimage keys, StepFrequency and Meta;
  - Cannon VM runs (registers, hi/lo, heap, memory pages, step, exit: the
    whole state JSON) and LWL/LWR; the preimage and hint protocol over an
    in-memory oracle;
  - build_elf, load_elf and state_from_elf on little- and big-endian blobs;
  - mips.execute against the port's CannonVM on cannon_ext_program and on
    the Cannon snapshot segment of tests/test_torch_column_vectors.py;
  - the port's CLI under `python -m`: its out.json, snapshots and printed
    lines equal the JAX CLI's, and it imports no JAX;
  - PreImageOracle against a host program written here (fds 3-6): the
    port's answers a VM run's hints and preimage reads, where the JAX
    package's finds the host's channels closed (a fault of the JAX package,
    not ported)."""

import json
import pathlib
import subprocess
import sys

import pytest

import chip_smoke
from proof_systems_tpu.o1vm import cannon as jcannon
from proof_systems_tpu.o1vm import elf as jelf
from proof_systems_tpu_torch.o1vm import cannon, elf, mips
from tests.test_cannon import addiu, lb, lui, ori, sw, syscall
from tests.test_mips import cannon_ext_program
from tests.test_torch_column_vectors import (
    SNAPSHOT_KEY,
    SNAPSHOT_PC0,
    SNAPSHOT_PREIMAGES,
    snapshot_memory,
    snapshot_program,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = {"port": (cannon, elf), "jax": (jcannon, jelf)}


def fresh_state(mod, program, base=0):
    """tests/test_cannon.py's fresh_state in the package `mod`."""
    st = mod.State(memory={})
    mem = mod.PagedMemory(st.memory)
    for i, w in enumerate(program):
        mem.write_word(base + 4 * i, w)
    st.pc, st.next_pc = base, base + 4
    return st


def dump(st) -> str:
    return json.dumps(st.to_json())


def test_state_json_equals_jax_and_round_trips(tmp_path):
    paths = {}
    for name, (mod, _) in PACKAGES.items():
        st = fresh_state(mod, [lui(8, 0x1234), ori(8, 8, 0x5678)])
        st.registers[5] = 0xDEADBEEF
        st.preimage_key = bytes(range(32))
        st.heap = 0x20000000
        st.last_hint, st.preimage = b"\x00\x00", b"data"
        mod.PagedMemory(st.memory).write_word(0x7FFC, 0xCAFEBABE)  # a second page
        paths[name] = tmp_path / f"{name}.json"
        st.save(str(paths[name]))
    raw = paths["port"].read_bytes()
    assert raw == paths["jax"].read_bytes()
    obj = json.loads(raw)
    assert obj["preimageKey"] == "0x" + bytes(range(32)).hex() and obj["nextPC"] == 4
    back = cannon.State.load(str(paths["jax"]))
    assert dump(back) == dump(jcannon.State.load(str(paths["port"])))
    assert json.dumps(back.to_json()) == raw.decode()
    assert sorted(back.memory) == [0, 7] and all(len(p) == cannon.PAGE_SIZE
                                                  for p in back.memory.values())


def test_preimage_keys_step_frequency_and_meta(tmp_path):
    for s in ("0x" + "ab" * 32, "cd" * 32, "0x" + "00" * 31 + "ff"):
        assert cannon.parse_preimage_key(s) == jcannon.parse_preimage_key(s)
    for mod in (cannon, jcannon):
        with pytest.raises(ValueError, match="32-bytes"):
            mod.parse_preimage_key("0xabcd")
    for s in ("never", "always", "=7", "%3", "%0", "4..10", "4.."):
        f, jf = cannon.StepFrequency.parse(s), jcannon.StepFrequency.parse(s)
        assert (f.kind, f.a, f.b) == (jf.kind, jf.a, jf.b)
        assert [f.matches(i) for i in range(40)] == [jf.matches(i) for i in range(40)]
    for mod in (cannon, jcannon):
        with pytest.raises(ValueError, match="Unknown frequency"):
            mod.StepFrequency.parse("sometimes")
    path = tmp_path / "meta.json"
    path.write_text(json.dumps({"symbols": [{"name": "bar", "start": 0x2000, "size": 16},
                                            {"name": "foo", "start": 0x1000, "size": 32}]}))
    meta, jmeta = cannon.Meta.load(str(path)), jcannon.Meta.load(str(path))
    assert meta.symbols == jmeta.symbols
    addrs = range(0xFF0, 0x2020, 4)
    assert [meta.find_address_symbol(a) for a in addrs] == [
        jmeta.find_address_symbol(a) for a in addrs]
    assert meta.find_address_symbol(0x1010) == "foo" and meta.find_address_symbol(0x1020) is None


def vm_case(mod, name):
    """A Cannon state and its VM's oracle for each run below."""
    if name == "arith_mem_exit":  # tests/test_cannon.py's test_vm_arith_mem_and_exit
        prog = [lui(8, 0x1234), ori(8, 8, 0x5678), sw(8, 0, 0x100), lb(9, 0, 0x100),
                lb(10, 0, 0x103), addiu(2, 0, 4246), addiu(4, 0, 7), syscall()]
        return fresh_state(mod, prog), None
    if name == "cannon_ext":  # tests/test_mips.py's full-ISA program
        prog = [chip_smoke.mips_encode(i) for i in cannon_ext_port()]
        st = fresh_state(mod, prog)
        st.heap = 0x20000000
        return st, None
    if name == "loop":  # chip_smoke.py's loop program, 1,024 steps
        prog = [chip_smoke.mips_encode(i) for i in chip_smoke.mips_loop_program(1024)]
        return fresh_state(mod, prog), mod.InMemoryPreImageOracle(chip_smoke.MIPS_PREIMAGES)
    st = mod.State(memory={}, pc=SNAPSHOT_PC0, next_pc=SNAPSHOT_PC0 + 4)  # the snapshot
    mem = mod.PagedMemory(st.memory)
    for w, ins in enumerate(snapshot_program(mips)):
        mem.write_word(SNAPSHOT_PC0 + 4 * w, chip_smoke.mips_encode(ins))
    for addr, val in snapshot_memory().items():
        mem.write_word(addr, val)
    return st, mod.InMemoryPreImageOracle(SNAPSHOT_PREIMAGES)


def cannon_ext_port():
    return [mips.Instr(i.op, i.rd, i.rs, i.rt, i.imm) for i in cannon_ext_program()]


@pytest.mark.parametrize("name", ["arith_mem_exit", "cannon_ext", "loop", "snapshot"])
def test_vm_runs_equal_jax(name):
    (st, oracle), (jst, joracle) = vm_case(cannon, name), vm_case(jcannon, name)
    cannon.CannonVM(st, oracle=oracle).run(max_steps=2000)
    jcannon.CannonVM(jst, oracle=joracle).run(max_steps=2000)
    assert dump(st) == dump(jst)
    assert st.exited
    if name == "arith_mem_exit":  # tests/test_cannon.py's checks
        assert st.exit == 7 and st.step == 8
        assert st.registers[8:11] == [0x12345678, 0x12, 0x78]
    if name == "snapshot":  # tests/test_mips.py's
        assert st.exit == 3 and st.registers[9] == 0x11223344 and st.preimage_key == SNAPSHOT_KEY
    if name == "loop":
        assert st.exit == 3 and st.step == 1024


def test_lwl_lwr_big_endian():
    for mod in (cannon, jcannon):
        st = fresh_state(mod, [])
        vm = mod.CannonVM(st)
        vm.mem.write_word(0x200, 0xAABBCCDD)
        st.registers[4], st.registers[8] = 0x200, 0x11223344
        vm.mem.write_word(0, (0x22 << 26) | (4 << 21) | (8 << 16) | 2)  # LWL r8, 2(r4)
        vm.step()
        assert st.registers[8] == 0xCCDD3344
        st.pc, st.next_pc = 8, 12
        st.registers[8] = 0x11223344
        vm.mem.write_word(8, (0x26 << 26) | (4 << 21) | (8 << 16) | 1)  # LWR r8, 1(r4)
        vm.step()
        assert st.registers[8] == 0x1122AABB


def protocol(mod):
    """tests/test_cannon.py's preimage read/write and hint exchanges: the
    stream read back, the hints, the final state."""
    key, data = bytes([9] * 32), b"hello preimage world"
    oracle = mod.InMemoryPreImageOracle({key: data})
    st = fresh_state(mod, [])
    vm = mod.CannonVM(st, oracle=oracle)
    for i in range(0, 32, 4):
        vm.mem.write_word(0x300 + i, int.from_bytes(key[i:i + 4], "big"))
    regs = st.registers
    for i in range(0, 32, 4):
        regs[4], regs[5], regs[6] = mod.FD_PREIMAGE_WRITE, 0x300 + i, 4
        assert vm._sys_write(regs) == (4, 0)
    assert st.preimage_key == key and st.preimage_offset == 0
    out, addr = bytearray(), 0x400
    while True:
        regs[4], regs[5], regs[6] = mod.FD_PREIMAGE_READ, addr + len(out), 4
        n, err = vm._sys_read(regs)
        assert err == 0
        if n == 0:
            break
        out += bytes(vm.mem.read_byte(addr + len(out) + i) for i in range(n))
    assert out == len(data).to_bytes(8, "big") + data
    hint = b"do-the-thing"
    msg = len(hint).to_bytes(4, "big") + hint
    for i, byte in enumerate(msg):
        vm.mem.write_byte(0x500 + i, byte)
    regs[4], regs[5], regs[6] = 4, 0x500, 5
    vm._sys_write(regs)
    assert oracle.hints == []
    regs[4], regs[5], regs[6] = 4, 0x505, len(msg) - 5
    vm._sys_write(regs)
    assert oracle.hints == [hint] and st.last_hint == b""
    return bytes(out), oracle.hints, dump(st)


def test_preimage_and_hint_protocol_equal_jax():
    assert protocol(cannon) == protocol(jcannon)


def elf_blobs(mod):
    prog = [addiu(8, 0, 5), addiu(8, 8, 6), addiu(2, 0, 4246), addiu(4, 0, 0), syscall()]
    out = {}
    for endian in ("big", "little"):
        text = b"".join(w.to_bytes(4, endian) for w in prog)
        out[endian] = mod.build_elf(mod.EM_MIPS, 0x1000, text, endian=endian)
        out[endian + "+data"] = mod.build_elf(mod.EM_RISCV, 0x2000, text,
                                              data=(0x8000, b"\x01\x02\x03\x04\x05"),
                                              endian=endian)
    return out


def test_elf_build_and_load_equal_jax():
    blobs, jblobs = elf_blobs(elf), elf_blobs(jelf)
    assert blobs == jblobs
    for name, blob in blobs.items():
        prog, jprog = elf.load_elf(blob), jelf.load_elf(blob)
        assert (prog.entry, prog.machine, prog.endian) == (jprog.entry, jprog.machine, jprog.endian)
        assert [(s.vaddr, s.data, s.flags) for s in prog.segments] == [
            (s.vaddr, s.data, s.flags) for s in jprog.segments]
        assert prog.memory_image() == jprog.memory_image()
        assert prog.text_words() == jprog.text_words()
        assert prog.text_words()[0] == addiu(8, 0, 5)
    for bad, msg in ((b"\x7fELX" + bytes(60), "not an ELF"), (b"\x7fELF\x02" + bytes(60), "ELF32")):
        for mod in (elf, jelf):
            with pytest.raises(ValueError, match=msg):
                mod.load_elf(bad)


def test_state_from_elf_mips_be():
    blob = elf_blobs(elf)["big"]
    st, jst = cannon.state_from_elf(blob), jcannon.state_from_elf(blob)
    assert st.pc == 0x1000 and st.next_pc == 0x1004
    assert dump(st) == dump(jst)
    cannon.CannonVM(st).run(max_steps=50)
    assert st.exited and st.registers[8] == 11


@pytest.mark.parametrize("name", ["cannon_ext", "snapshot"])
def test_mips_execute_matches_the_cannon_vm(name):
    """mips.execute bit for bit against the port's CannonVM: registers,
    hi/lo, heap, every memory word execute wrote, the preimage key, exit."""
    st, oracle = vm_case(cannon, name)
    vm = cannon.CannonVM(st, oracle=oracle)
    vm.run(max_steps=400)
    if name == "cannon_ext":
        rows, state = mips.execute(cannon_ext_port(), 400, heap0=0x20000000)
    else:
        rows, state = mips.execute(snapshot_program(mips), 100, memory=snapshot_memory(),
                                   pc0=SNAPSHOT_PC0, preimages=SNAPSHOT_PREIMAGES)
    assert st.exited and state["exited"] and st.exit == state["exit_code"]
    assert st.registers == state["regs"]
    assert (st.hi, st.lo, st.heap, st.preimage_key) == (
        state["hi"], state["lo"], state["heap"], state["pk"])
    for addr, val in state["memory"].items():
        assert vm.mem.read_word(addr) == val, hex(addr)


def cli(package: str, args: list[str]) -> subprocess.CompletedProcess:
    """`python -X importtime -m <package>.o1vm.cli cannon run ...` from the
    repository's root: stderr lists every module the process imported."""
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", f"{package}.o1vm.cli", "cannon", "run", *args],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out


def imported(stderr: str) -> set[str]:
    return {line.rsplit("|", 1)[1].strip().split(".")[0]
            for line in stderr.splitlines() if line.startswith("import time:") and "|" in line}


def test_cli_equals_jax(tmp_path):
    """tests/test_cannon.py's CLI run, and one with --stop-at, --info-at,
    --snapshot-state-at and --meta, through each package's CLI."""
    prog = [addiu(8, 0, 41), addiu(8, 8, 1), addiu(2, 0, 4246), addiu(4, 0, 3), syscall()]
    (tmp_path / "state.json").write_text(json.dumps(fresh_state(cannon, prog).to_json()))
    (tmp_path / "meta.json").write_text(json.dumps(
        {"symbols": [{"name": "main", "start": 0, "size": 8}]}))
    outs = {}
    for package in ("proof_systems_tpu_torch", "proof_systems_tpu"):
        runs = []
        for extra in ([], ["--stop-at", "=4", "--info-at", "%2",
                           "--meta", f"{tmp_path}/meta.json", "--snapshot-state-at", "=1",
                           "--snapshot-fmt", f"{tmp_path}/{package}-%d.json"]):
            out = cli(package, ["--input", f"{tmp_path}/state.json",
                                "--output", f"{tmp_path}/{package}.json", *extra])
            runs.append((out.stdout, (tmp_path / f"{package}.json").read_bytes()))
            if package == "proof_systems_tpu_torch":
                assert not imported(out.stderr) & {"jax", "jaxlib", "proof_systems_tpu"}
                assert "proof_systems_tpu_torch" in imported(out.stderr)
        runs.append(((tmp_path / f"{package}-1.json").read_bytes(), None))
        outs[package] = runs
    assert outs["proof_systems_tpu_torch"] == outs["proof_systems_tpu"]
    (stdout, raw), (stdout2, raw2), _ = outs["proof_systems_tpu_torch"]
    final = cannon.State.load(str(tmp_path / "proof_systems_tpu_torch.json"))
    assert stdout == "step=5 pc=0x10 exited=True exit=3\n"
    assert json.loads(raw)["exited"] and json.loads(raw)["registers"][8] == 42
    assert stdout2.splitlines() == ["step=0 pc=0x0 main", "step=2 pc=0x8 ",
                                    "step=4 pc=0x10 exited=False exit=0"]
    assert final.step == 4 and not final.exited


# A preimage host on the Cannon channels: hints on fd 3 (u64-BE length, then
# the hint; a 1-byte ack on fd 4), keys on fd 5 (32 bytes; the answer on fd 6
# as a u64-BE length and the data: the hints so far, joined by "|", then the
# key's first four bytes).
HOST = """
import os, select

def read_exact(fd, n):
    buf = b""
    while len(buf) < n:
        chunk = os.read(fd, n - len(buf))
        if not chunk:
            raise SystemExit(0)
        buf += chunk
    return buf

hints = []
while True:
    ready, _, _ = select.select([3, 5], [], [])
    if 3 in ready:
        hints.append(read_exact(3, int.from_bytes(read_exact(3, 8), "big")))
        os.write(4, b"\\x01")
    if 5 in ready:
        key = read_exact(5, 32)
        data = b"|".join(hints) + key[:4]
        os.write(6, len(data).to_bytes(8, "big") + data)
"""


@pytest.fixture
def host(tmp_path):
    path = tmp_path / "host.py"
    path.write_text(HOST)
    return [sys.executable, str(path)]


def test_preimage_oracle_serves_a_vm_run_from_a_host_process(host):
    """The port's PreImageOracle starts the host with its channels on fds
    3-6: a guest's hint (a u32-BE length-prefixed message written to fd 4)
    reaches it and is acknowledged, and the guest reads the answer to its
    key (written to fd 6) back from fd 5."""
    I = mips.Instr  # noqa: E741
    prog = [I("ADDIU", rt=4, rs=0, imm=4), I("ADDIU", rt=5, rs=0, imm=0x500),
            I("ADDIU", rt=6, rs=0, imm=9), I("ADDIU", rt=2, rs=0, imm=4004), I("SYSCALL"),
            I("ADDIU", rt=4, rs=0, imm=6), I("ADDIU", rt=6, rs=0, imm=4)]
    for w in range(8):
        prog += [I("ADDIU", rt=5, rs=0, imm=0x100 + 4 * w), I("ADDIU", rt=2, rs=0, imm=4004),
                 I("SYSCALL")]
    prog += [I("ADDIU", rt=4, rs=0, imm=5)]
    for a in (0x200, 0x204, 0x208, 0x20C, 0x210):
        prog += [I("ADDIU", rt=5, rs=0, imm=a), I("ADDIU", rt=2, rs=0, imm=4003), I("SYSCALL")]
    prog += [I("ADDIU", rt=2, rs=0, imm=4246), I("ADDIU", rt=4, rs=0, imm=0), I("SYSCALL")]
    st = fresh_state(cannon, [chip_smoke.mips_encode(i) for i in prog])
    vm = cannon.CannonVM(st)
    for w in range(8):
        vm.mem.write_word(0x100 + 4 * w, int.from_bytes(SNAPSHOT_KEY[4 * w:4 * w + 4], "big"))
    for i, byte in enumerate(len(b"hello").to_bytes(4, "big") + b"hello"):
        vm.mem.write_byte(0x500 + i, byte)
    oracle = cannon.PreImageOracle(host[0], host[1:])
    oracle.start()
    try:
        vm.oracle = oracle
        vm.run(max_steps=200)
        assert oracle.hint(b"more") is None  # acknowledged
        second = oracle.get_preimage(bytes(32))
    finally:
        oracle.close()
    data = b"hello" + SNAPSHOT_KEY[:4]
    assert st.exited and st.preimage == data
    stream = len(data).to_bytes(8, "big") + data
    assert bytes(vm.mem.read_byte(0x200 + i) for i in range(len(stream))) == stream
    assert second == b"hello|more" + bytes(4)


def test_jax_oracle_closes_the_host_channels(host):
    """The fault of the JAX package that the port does not copy: its
    PreImageOracle moves the child's pipe ends to fds 3-6 in preexec_fn, but
    subprocess then closes every fd not in pass_fds (the original numbers),
    so the same host finds its channels closed and the exchange fails
    (EOFError once the host exits; BrokenPipeError if it exited before the
    write). The port's oracle answers."""
    jo = jcannon.PreImageOracle(host[0], host[1:])
    jo.start()
    try:
        with pytest.raises((EOFError, BrokenPipeError)):
            jo.hint(b"abc")
    finally:
        jo.close()
    port = cannon.PreImageOracle(host[0], host[1:])
    port.start()
    try:
        port.hint(b"abc")
        assert port.get_preimage(bytes(range(32))) == b"abc" + bytes(range(4))
    finally:
        port.close()
