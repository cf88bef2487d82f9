from cover_vla_tpu_torch.robot.devices import (
    Camera, MotorBus, MockCamera, MockMotorBus, RobotInterface,
    make_mock_robot)
