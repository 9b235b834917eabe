"""The multi-device layer on torch.distributed: one process per device, the
default process group (NCCL on cards, gloo on the CPU), every rank running
the same program on the same replicated inputs and sharding its share of
the work; collectives put the results back together so that every rank
ends up with identical values.

Counterpart of proof_systems_tpu/parallel/ (a ('data',) mesh of one
process's chips under GSPMD there)."""
