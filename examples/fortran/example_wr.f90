! example_wr.f90 — Fortran round trip through libwaverange's Fortran ABI
! (the analogue of the reference's examples/fortran/example_fort.f90:
! setup_wr_f -> encoding_wrap_f -> decoding_wrap_f, self-checked).
!
! Build: python -m waverange.native.libwaverange
!        gfortran -O2 -o example_wr example_wr.f90 \
!            -L../../build/lib -lwaverange -Wl,-rpath,<abs path to build/lib>
!
! NOTE: the encoder clobbers its input array (reference contract).
program example_wr
  implicit none
  integer, parameter :: n = 32
  integer :: nx, ny, nz, wtflag, nlaymax
  integer (kind=8) :: ntot_enc_max, ntot_enc
  integer (kind=8) :: len_enc_vec(8)
  real (kind=8), allocatable :: fld(:,:,:), fld_ini(:,:,:), fld_rec(:,:,:)
  real (kind=8) :: tolrel, tolabs, midval, halfspanval
  real (kind=8) :: deps_vec(8), minval_vec(8)
  character :: wlev, nlay
  character, allocatable :: data_enc(:)
  integer :: i, j, k
  real (kind=8) :: err

  nx = n; ny = n; nz = n
  wtflag = 1
  tolrel = 1.0d-6

  call setup_wr_f(nx, ny, nz, nlaymax, ntot_enc_max)
  allocate(fld(nx,ny,nz), fld_ini(nx,ny,nz), fld_rec(nx,ny,nz))
  allocate(data_enc(ntot_enc_max))

  do k = 1, nz
    do j = 1, ny
      do i = 1, nx
        fld(i,j,k) = 10.0d0 * sin(dble(i)/16.0d0) * sin(dble(j)/16.0d0) &
                     * cos(dble(k)/16.0d0)
      end do
    end do
  end do
  fld_ini = fld

  call encoding_wrap_f(nx, ny, nz, fld, wtflag, tolrel, tolabs, midval, &
                       halfspanval, wlev, nlay, ntot_enc, deps_vec, &
                       minval_vec, len_enc_vec, data_enc)
  write(*,*) 'ntot_enc = ', ntot_enc

  call decoding_wrap_f(nx, ny, nz, fld_rec, midval, halfspanval, wlev, &
                       nlay, ntot_enc, deps_vec, minval_vec, &
                       len_enc_vec, data_enc)

  err = maxval(abs(fld_rec - fld_ini))
  write(*,*) 'err_linf_abs = ', err
  write(*,*) 'err_linf_rel = ', err / maxval(abs(fld_ini))
  if (err <= 1.3d0 * tolrel * maxval(abs(fld_ini))) then
    write(*,*) 'PASS'
  else
    write(*,*) 'FAIL'
    stop 1
  end if
end program example_wr
