"""The benchmark's plain reference: plain PyTorch, no kernels, nothing of
the measured program (``dslabs_tpu_torch``) and nothing of the JAX
package.  ``paxos`` is a frozen copy of the lab 3 Paxos twin; ``bfs`` is
an exact breadth-first search over such a twin with its own network
set, timer queues, partition fault plane and visited set."""
