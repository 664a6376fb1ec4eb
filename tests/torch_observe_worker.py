"""Worker for tests/test_torch_observe.py, started by the PyTorch
package's launcher: one gloo rank that trains a small MLP for STEPS
steps through DistributedOptimizer (its gradients in several buckets)
and prints, as one JSON line, its rank, whether it holds the timeline,
its bucket count and perfscope's step count. hvd.shutdown() then pushes
its perfscope summary to the launcher's KV."""

import json

STEPS = 3


def main() -> None:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import topology

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    try:
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                    torch.nn.Linear(16, 4))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        for _ in range(STEPS):
            opt.zero_grad()
            model(torch.randn(4, 8)).square().mean().backward()
            opt.step()
        print(json.dumps({
            "rank": hvd.rank(), "timeline": topology.timeline() is not None,
            "buckets": len(opt.plan),
            "steps": hvd.perfscope().summary()["steps"]}), flush=True)
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
