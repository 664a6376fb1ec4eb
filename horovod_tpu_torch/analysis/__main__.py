from horovod_tpu_torch.analysis.driver import main

main()
