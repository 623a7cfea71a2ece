#! /bin/bash
# DexYCB training with the PyTorch/CUDA port, in the reference's layout:
# one process per card through torchrun, 8 processes x batch 4 (reference
# HOIG_DexYCB/scripts/train_ycb_ddp.sh). --batch_size is per card; the
# processes average their gradients over NCCL (hoig_torch/parallel).
# NPROC=1 trains on one card. The hyperparameters are those of
# scripts/train_ycb_ddp.sh, final_lr 5e-5 included.

nproc=${NPROC:-8}

dataset_mode=ycb
data_dir=${DATA_DIR:-/mnt/blob/data/DexYCB}
params_dir=params
images_dir=images

checkpoints_dir=checkpoints
name=exp_ycb

model=trainer
gen_name=generator_spade_attn
image_size=256

load_path="None"
batch_size=${BATCH_SIZE:-4}
lambda_rec=10.0
lambda_tsf=10.0
lambda_mask=1.0
lambda_mask_smooth=1.0
nepochs_no_decay=15
nepochs_decay=15

python -m torch.distributed.run --standalone --nproc_per_node ${nproc} train_torch.py \
        --data_dir                ${data_dir}          \
        --params_dir              ${params_dir}        \
        --images_dir              ${images_dir}        \
        --checkpoints_dir         ${checkpoints_dir}   \
        --load_path               ${load_path}         \
        --model                   ${model}             \
        --gen_name                ${gen_name}          \
        --name                    ${name}              \
        --dataset_mode            ${dataset_mode}      \
        --image_size              ${image_size}        \
        --batch_size              ${batch_size}        \
        --lambda_tsf              ${lambda_tsf}        \
        --lambda_rec              ${lambda_rec}        \
        --lambda_mask             ${lambda_mask}       \
        --lambda_mask_smooth      ${lambda_mask_smooth}\
        --nepochs_no_decay        ${nepochs_no_decay}  \
        --nepochs_decay           ${nepochs_decay}     \
        --num_repeats             10                   \
        --final_lr                0.00005              \
        --vgg_weights            ${vgg_weights:-assets/weights/vgg19.npz} \
        --mask_bce --use_vgg --use_spade
