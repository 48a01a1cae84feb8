"""The plain reference: plain PyTorch, a frozen copy of the port's plain
path (physics `_step_scan`, the steppers of Walker3D and Cassie, the
networks, GAE and the PPO update), cut to one process, plus the
teacher-forced and free-running drivers the check needs.

It imports nothing of the port, of the JAX package or of JAX: the
benchmark judges the port against it, and tests/test_bench_guard.py
holds it to that."""
